"""The training loop (PyTorch port of ``training/trainer.py``), both stages.

Assembles model, data, loss, optimizer, logging and checkpointing: synthetic
or streamed batches -> ``Trainer.fit`` -> bf16 forward with fp32 params,
sampling the latent -> L1 + LPIPS (VGG, or ``perceptual='self'``: a trained
checkpoint's frozen encoder) + KL + VF (with a teacher: the eager
projection ``vf_proj``, trained, in the EMA and the checkpoint) -> backward
-> clip, AdamW or Adafactor with warmup and NaN-skip -> checkpoint.
Validation PSNR/SSIM every ``eval_every_steps``, a best checkpoint, the
divergence breaker, a checkpoint on SIGTERM/SIGINT, and
``skip_data_on_resume``, as in the JAX trainer. Logged rows go to
``<output_dir>/history.jsonl`` and, with tensorboardX installed, as
TensorBoard scalars to ``<output_dir>/tb`` (train rows, val rows and the
epoch averages, at the JAX trainer's steps). ``DEEPL_DEBUG_NANS`` set in
the environment turns on autograd's anomaly mode for the run.

Stage 2 (``weights.gan > 0``): a PatchGAN discriminator with its own AdamW
(no warmup, no freeze) and its own step count, trained by
``make_gan_train_step`` one update per generator update; its parameters,
optimizer and step go in the checkpoint. A stage hand-off resumes as in the
JAX trainer (:meth:`Trainer.maybe_resume`).

Under a process group (torchrun; ``parallel.initialize_multihost``) the
trainer builds the (data, 1, mesh_model) mesh over its ranks and places the
parameters by ``param_sharding`` (``parallel.shard_params``: replicate,
fsdp or tensor), as the JAX trainer does over its devices: each rank trains
on its rows of every global batch (``fit`` takes the global batch and keeps
the rank's rows, or takes them already split, [batch_size / data, ...]),
the steps average gradients and metrics over the data group, validation
splits each batch over data, and checkpoints hold whole tensors (gathered
on save, which rank 0 writes; sliced on restore), so a checkpoint crosses
placements and process counts both ways. A global batch that does not
split over world / mesh_model data ranks trains, as in the JAX trainer, on
a subset mesh of the first gcd(batch, world / mesh_model) x mesh_model
ranks; each rank left out says so, takes no step, writes nothing and
returns from ``fit`` when the mesh's ranks finish it (a barrier over the
world), so a torchrun job of such a batch exits 0. Without a process group
nothing of this runs: one process,
one device, ``mesh_model`` 1 (``param_sharding`` then places nothing, as
in the JAX rules at a model axis of 1).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..config import TransVAEConfig
from ..losses import (LossWeights, get_lpips_params, lpips_params_available,
                      make_self_perceptual)
from ..models.discriminator import PatchDiscriminator, init_disc_weights
from ..models.transvae import TransVAE, init_weights, resolve_device
from ..parallel import Placement, create_mesh, data_axis_size, shard_batch, shard_params
from ..parallel.sharding import MODES
from ..utils.logging import MetricWriter, RunHistory, StepTimer, is_primary
from ..utils.metrics import psnr, ssim
from .checkpoint import (checkpoint_metrics, latest_step, load_config, restore_checkpoint,
                         restore_model_params, save_checkpoint)
from .optim import make_optimizer
from .schedule import warmup_cosine
from .train_step import (TrainState, init_ema, make_gan_train_step, make_train_step,
                         make_vf_proj_params, named_trainables)

# How long a rank left out of a subset mesh waits for the mesh's ranks to
# finish fit(): the whole run, so far longer than the process group's
# timeout.
RELEASE_TIMEOUT = datetime.timedelta(days=365)


@dataclasses.dataclass
class TrainerConfig:
    """Training hyperparameters: the JAX ``TrainerConfig``'s fields and
    defaults (see there for each one's history)."""

    batch_size: int = 16
    accum_steps: int = 1
    learning_rate: float = 1e-4
    warmup_steps: int = 10_000
    num_epochs: int = 100
    steps_per_epoch: int = 1000
    max_grad_norm: float = 1.0
    freeze_encoder: bool = False
    weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    use_lpips: bool = True
    perceptual: str = "vgg"
    perceptual_checkpoint: str = ""
    resolution: int = 256
    seed: int = 42
    log_every: int = 100
    save_every_epochs: int = 5
    save_every_steps: int = 0
    eval_every_steps: int = 0
    output_dir: str = "outputs"
    mesh_model: int = 1
    param_sharding: str = "replicate"
    mu_dtype: str | None = None
    optimizer: str = "adamw"
    ema_decay: float = 0.0
    keep_best: bool = True
    gan_adaptive_weight: bool = False
    gan_warmup_steps: int = 0
    gan_ramp_steps: int = 1
    gan_adaptive_max: float = 1.0
    gan_disc_loss_floor: float = 0.6
    gan_r1_gamma: float = 10.0
    lr_schedule: str = "constant"
    divergence_halt_db: float = 5.0
    divergence_patience: int = 3
    skip_data_on_resume: bool = False


class Trainer:
    def __init__(self, model_config: TransVAEConfig, train_config: TrainerConfig,
                 teacher_fn=None, device=None):
        """``teacher_fn`` (``losses.teachers``; images -> features, with a
        ``feature_dim``) turns the VF term on: ``create_state`` makes the
        projection to its width."""
        cfg = train_config
        if cfg.perceptual not in ("vgg", "self"):
            raise ValueError(f"perceptual must be vgg|self, got {cfg.perceptual!r}")
        if cfg.param_sharding not in MODES:
            raise ValueError(f"param_sharding must be one of {MODES}, got "
                             f"{cfg.param_sharding!r}")
        if cfg.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"lr_schedule must be constant|cosine, got {cfg.lr_schedule!r}")
        self.mesh = self.placement = self.disc_placement = None
        # A subset mesh (data_axis_size): the barrier group of its ranks
        # (save) and the world's group that holds the ranks left out until
        # the mesh's ranks finish (fit); whether this rank is left out.
        self._mesh_group = self._release_group = None
        self.outside = False
        if dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
            data = data_axis_size(cfg.batch_size, world, cfg.mesh_model)
            ranks = data * cfg.mesh_model
            # Every rank of the world enters each group's creation, in order.
            mesh = create_mesh(data=data, model=cfg.mesh_model, ranks=ranks)
            if ranks < world:
                self._mesh_group = dist.new_group(list(range(ranks)))
                self._release_group = dist.new_group(backend="gloo", timeout=RELEASE_TIMEOUT)
                if rank == 0:
                    print(f"[trainer] subset mesh: data {data} x model {cfg.mesh_model} on ranks "
                          f"0-{ranks - 1} of {world} (global batch {cfg.batch_size}: "
                          f"gcd(batch, {world} / mesh_model {cfg.mesh_model}) data ranks)")
            if mesh.get_coordinate() is None:
                self.outside = True
                self.model_config, self.cfg = model_config, cfg
                print(f"[trainer] rank {rank} is outside the subset mesh of ranks 0-{ranks - 1}: "
                      "it takes no step and writes nothing; fit() waits for the mesh's ranks")
                return
            self.mesh = mesh
            self.placement = Placement(self.mesh, cfg.param_sharding)
            self.disc_placement = Placement(self.mesh)  # replicated
        elif cfg.mesh_model > 1:
            raise ValueError(f"mesh_model={cfg.mesh_model} needs that many ranks a model "
                             "group: launch under torchrun (python -m torch.distributed.run)")
        self.model_config = model_config
        self.cfg = cfg
        self.device = resolve_device(device)
        self.teacher_fn = teacher_fn
        self.dino_dim = getattr(teacher_fn, "feature_dim", None)

        self.lpips_params = None
        self.perceptual_fn = None
        if cfg.perceptual == "self":
            # As in the JAX trainer, the net is built and the banner printed
            # whatever the lpips weight; the loss gates the term on it.
            self.perceptual_fn = self._self_perceptual()
        elif cfg.use_lpips and cfg.weights.lpips > 0:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 7)
            self.lpips_params = get_lpips_params(device=self.device, generator=gen)
            if not lpips_params_available():
                print("[trainer] WARNING: no pretrained LPIPS weights found; "
                      "using random-init VGG (run scripts/convert_lpips_weights.py)")
        self.use_gan = cfg.weights.gan > 0
        self._disc_state: TrainState | None = None
        if self.use_gan:
            # As the JAX GAN step, this one takes the whole batch:
            # accum_steps does not apply to stage 2.
            gan_step = make_gan_train_step(
                cfg.weights, self.lpips_params,
                adaptive_weight=cfg.gan_adaptive_weight,
                ema_decay=cfg.ema_decay or None,
                gan_warmup_steps=cfg.gan_warmup_steps,
                gan_ramp_steps=cfg.gan_ramp_steps,
                adaptive_max=cfg.gan_adaptive_max,
                disc_loss_floor=cfg.gan_disc_loss_floor,
                r1_gamma=cfg.gan_r1_gamma, seed=cfg.seed, teacher_fn=teacher_fn,
                perceptual_fn=self.perceptual_fn, placement=self.placement,
                disc_placement=self.disc_placement)

            def gan_adapter(state, batch):
                return gan_step(state, self._ensure_disc_state(), batch)

            self.step_fn = gan_adapter
        else:
            self.step_fn = make_train_step(cfg.weights, self.lpips_params,
                                           accum_steps=cfg.accum_steps,
                                           ema_decay=cfg.ema_decay or None,
                                           seed=cfg.seed, teacher_fn=teacher_fn,
                                           perceptual_fn=self.perceptual_fn,
                                           placement=self.placement)
        self._best_psnr = float("-inf")
        self._best_raw_psnr = float("-inf")

    def _self_perceptual(self):
        """The frozen feature net of ``perceptual='self'``: the model of
        ``perceptual_checkpoint`` (its saved config, its EMA parameters when
        it has them) on the device."""
        path = self.cfg.perceptual_checkpoint
        if not path:
            raise ValueError("perceptual='self' needs perceptual_checkpoint (a trained "
                             "checkpoint whose frozen encoder becomes the feature net)")
        with torch.device("meta"):
            net = TransVAE(load_config(path))
        net = net.to_empty(device=self.device)
        fn = make_self_perceptual(net, restore_model_params(path, map_location=self.device))
        print("[trainer] perceptual=self: LPIPS slot uses the frozen encoder from "
              f"{path} (self-perceptual distance, NOT VGG-LPIPS)")
        return fn

    # -- state -----------------------------------------------------------
    def _schedule(self):
        c = self.cfg
        if c.lr_schedule == "cosine":
            return warmup_cosine(c.learning_rate, c.warmup_steps,
                                 c.num_epochs * c.steps_per_epoch)
        return None

    def create_state(self) -> TrainState:
        """A model with weights drawn from ``seed`` on the device, with a
        teacher the VF projection (drawn next from the same generator), the
        optimizer over both and (with ema_decay) the EMA shadow of both.
        Under a mesh every rank draws the whole weights, then keeps its
        slices (``param_sharding``)."""
        with torch.device("meta"):
            model = TransVAE(self.model_config)
        model = model.to_empty(device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        init_weights(model, gen)
        vf_proj = None
        if self.teacher_fn is not None and self.dino_dim:
            vf_proj = make_vf_proj_params(self.model_config.latent_dim, self.dino_dim, gen,
                                          device=self.device)
        c = self.cfg
        if self.mesh is not None:
            shard_params(self.mesh, model, c.param_sharding, placement=self.placement)
            if vf_proj is not None:
                shard_params(self.mesh, vf_proj, c.param_sharding, prefix="vf_proj.",
                             placement=self.placement)
        opt = make_optimizer(named_trainables(model, vf_proj), learning_rate=c.learning_rate,
                             warmup_steps=c.warmup_steps, max_grad_norm=c.max_grad_norm,
                             freeze_encoder=c.freeze_encoder, mu_dtype=c.mu_dtype,
                             optimizer=c.optimizer, schedule=self._schedule(),
                             placement=self.placement)
        return TrainState(step=0, model=model, optimizer=opt, vf_proj=vf_proj,
                          ema=init_ema(model, vf_proj) if c.ema_decay else None)

    def _ensure_disc_state(self) -> TrainState:
        """The discriminator's train state, made at first use: weights from a
        generator seeded with seed + 1 (the JAX trainer's PRNGKey(seed + 1)
        is another stream), AdamW at the generator's rate without warmup."""
        if self._disc_state is None:
            mc, c = self.model_config, self.cfg
            with torch.device("meta"):
                disc = PatchDiscriminator(dtype=mc.compute_dtype, param_dtype=mc.params_dtype)
            disc = disc.to_empty(device=self.device)
            init_disc_weights(disc, torch.Generator(device=self.device).manual_seed(c.seed + 1))
            opt = make_optimizer(disc.named_parameters(), learning_rate=c.learning_rate,
                                 warmup_steps=0, max_grad_norm=c.max_grad_norm,
                                 placement=self.disc_placement)
            self._disc_state = TrainState(step=0, model=disc, optimizer=opt)
        return self._disc_state

    def maybe_resume(self, state: TrainState) -> tuple[TrainState, int]:
        """Restore the newest checkpoint under output_dir/checkpoints.

        The JAX trainer's rule: everything is restored only when the
        checkpoint's keys are the live state's (model, optimizer, step, ema
        with EMA on, vf_proj with a teacher, and with the GAN on the
        discriminator's keys the checkpoint has) and the saved optimizer is
        the same kind over the same trainable parameters (vf_proj's
        included). Otherwise (a stage hand-off: freeze_encoder toggled, EMA
        added, AdamW to Adafactor, a stage-2 checkpoint into stage 1) the
        model, the step and vf_proj when both have it: the optimizer stays
        fresh (its warmup starts again), the EMA shadow restarts from the
        restored parameters and the discriminator starts at step 0. A
        checkpoint without disc_step restores D at step 0. A checkpoint of
        the other block layout (``scan_blocks``) restores its parameters,
        EMA and AdamW moments converted; its Adafactor state does not
        (``utils.convert.resume_in_model_layout``)."""
        from ..utils.convert import resume_in_model_layout

        ckpt_dir = os.path.join(self.cfg.output_dir, "checkpoints")
        if latest_step(ckpt_dir) is None:
            return state, 0
        payload, meta = restore_checkpoint(ckpt_dir, map_location=self.device)
        keys = set(payload)
        live = ({"model", "optimizer", "step"}
                | ({"ema"} if state.ema is not None else set())
                | ({"vf_proj"} if state.vf_proj is not None else set()))
        if self.use_gan and "disc_model" in keys:
            live |= {"disc_model", "disc_optimizer"} | ({"disc_step"} & keys)
        full = keys == live
        saved_opt, saved_ema = resume_in_model_layout(state.model, payload.get("optimizer", {}),
                                                      payload.get("ema"))
        if full and (saved_opt is None or not state.optimizer.trains_as(saved_opt)):
            print("[trainer] structured restore failed (the saved optimizer is another "
                  "kind, trains other parameters or is Adafactor of the other block "
                  "layout); falling back to params/step-only restore")
            full = False
        self._load_params(state.model, payload["model"])
        if state.vf_proj is not None and "vf_proj" in payload:
            self._load_params(state.vf_proj, payload["vf_proj"], "vf_proj.")
        state.step = int(payload["step"])
        if full:
            state.optimizer.load_state_dict(saved_opt)
            if state.ema is not None:
                if self.placement is None:
                    with torch.no_grad():
                        for n, t in state.ema.items():
                            t.copy_(saved_ema[n])
                else:
                    self.placement.load_full(state.ema.items(), saved_ema)
            if "disc_model" in payload:
                disc = self._ensure_disc_state()
                disc.model.load_state_dict(payload["disc_model"], strict=True)
                disc.optimizer.load_state_dict(payload["disc_optimizer"])
                disc.step = int(payload.get("disc_step", 0))
        else:
            print(f"[trainer] WARNING: checkpoint keys {sorted(keys)} do not match the "
                  "live state; restoring params/step only (optimizer state reset)")
            if state.ema is not None:
                params = dict(named_trainables(state.model, state.vf_proj))
                with torch.no_grad():
                    for n, t in state.ema.items():
                        t.copy_(params[n])
        del payload
        best = checkpoint_metrics(os.path.join(self.cfg.output_dir, "checkpoints_best"))
        if best is not None:
            self._best_psnr = self._selection_psnr(best)
        print(f"[trainer] resumed from step {state.step} (epoch {meta['epoch']})")
        return state, meta["epoch"]

    # -- placement ----------------------------------------------------------
    def _load_params(self, module, saved: dict, prefix: str = "") -> None:
        """A whole state_dict into ``module``, this rank's slices under a mesh;
        a checkpoint of the other block layout (``scan_blocks``) converted
        (``utils.convert.in_model_layout``)."""
        from ..utils.convert import in_model_layout

        saved = in_model_layout(module, saved)
        if self.placement is None:
            module.load_state_dict(saved, strict=True)
        else:
            self.placement.load_full(named_trainables(module), saved, prefix)

    def _whole(self, module, prefix: str = "") -> dict:
        """``module``'s state_dict with whole tensors (gathered under a mesh:
        every rank calls it)."""
        if self.placement is None:
            return module.state_dict()
        return self.placement.full_state(named_trainables(module), prefix)

    def _local_batch(self, batch: torch.Tensor, accum_steps: int) -> torch.Tensor:
        """This rank's rows of a global batch; a batch already split passes."""
        if self.mesh is None or self.placement.data_size == 1:
            return batch
        if batch.shape[0] == self.cfg.batch_size:
            return shard_batch(self.mesh, batch, accum_steps)
        if batch.shape[0] * self.placement.data_size == self.cfg.batch_size:
            return batch
        raise ValueError(f"batch of {batch.shape[0]} rows: neither the global batch "
                         f"{self.cfg.batch_size} nor its share of "
                         f"{self.placement.data_size} data ranks")

    # -- validation -------------------------------------------------------
    @torch.no_grad()
    def _metrics(self, model, val_batches) -> dict:
        """Mean PSNR/SSIM over every image; under a mesh each data rank
        scores its rows of each batch and the sums are reduced over data."""
        vals: dict[str, list] = {"psnr": [], "ssim": []}
        for batch in val_batches:
            batch = np.asarray(batch)
            if self.mesh is not None:
                batch = shard_batch(self.mesh, batch)
            x = torch.as_tensor(batch).to(self.device).permute(0, 3, 1, 2)
            recon = torch.sigmoid(model(x.to(model.config.compute_dtype))[0].float())
            vals["psnr"].append(psnr(recon, x).cpu())
            vals["ssim"].append(ssim(recon, x).cpu())
        if self.mesh is None:
            return {k: float(torch.cat(v).mean()) for k, v in vals.items()}
        sums = torch.tensor([float(torch.cat(v).double().sum()) for v in vals.values()]
                            + [float(sum(len(t) for t in vals["psnr"]))],
                            dtype=torch.float64, device=self.device)
        dist.all_reduce(sums, group=self.placement.data_group)
        return {k: float(sums[i] / sums[-1]) for i, k in enumerate(vals)}

    def evaluate(self, state: TrainState, val_batches: list) -> dict:
        """Mean PSNR/SSIM over fixed validation batches; with EMA on, the
        shadow parameters are scored too (val_psnr_ema, ...)."""
        out = {f"val_{k}": v for k, v in self._metrics(state.model, val_batches).items()}
        if state.ema is not None:
            params = dict(named_trainables(state.model))
            with torch.no_grad():
                live = {n: p.detach().clone() for n, p in params.items()}
                for n, p in params.items():
                    p.copy_(state.ema[n])
                try:
                    ema = self._metrics(state.model, val_batches)
                finally:
                    for n, t in live.items():
                        params[n].copy_(t)
            out.update({f"val_{k}_ema": v for k, v in ema.items()})
        return out

    def _selection_psnr(self, val: dict) -> float:
        return val.get("val_psnr_ema", val.get("val_psnr", float("-inf")))

    # -- loop ------------------------------------------------------------
    def fit(self, data_iter: Iterator, state: TrainState | None = None,
            val_batches: list | None = None) -> TrainState:
        """Run the loop over ``data_iter`` ([B, H, W, 3] batches in [0, 1],
        numpy or tensors). SIGTERM/SIGINT finish the step, checkpoint and
        return; a second signal falls through to the previous handler."""
        if self.outside:
            dist.barrier(group=self._release_group)
            return state
        stop_signal: list[int | None] = [None]
        prev_handlers: dict[int, Any] = {}

        def _request_stop(signum, frame):
            if stop_signal[0] is not None:
                signal.signal(signum, prev_handlers.get(signum) or signal.SIG_DFL)
                raise KeyboardInterrupt
            stop_signal[0] = signum
            print(f"[trainer] received signal {signum}: will checkpoint and "
                  "stop after the current step")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not the main thread
                pass
        # DEEPL_DEBUG_NANS: autograd's anomaly mode names the op whose
        # backward made a NaN (the JAX trainer turns on jax_debug_nans).
        anomaly = torch.is_anomaly_enabled()
        if os.environ.get("DEEPL_DEBUG_NANS"):
            torch.autograd.set_detect_anomaly(True)
        writer = None
        try:
            if state is None:
                state = self.create_state()
            state, start_epoch = self.maybe_resume(state)
            writer = MetricWriter(os.path.join(self.cfg.output_dir, "tb"))
            history = RunHistory(os.path.join(self.cfg.output_dir, "history.jsonl"))
            if state.step and self.cfg.skip_data_on_resume:
                print(f"[trainer] skip_data_on_resume: advancing the data "
                      f"stream by {state.step} batches to the resume point")
                for _ in range(state.step):
                    if next(data_iter, None) is None:
                        break
            state = self._fit_loop(state, data_iter, val_batches, writer, history,
                                   start_epoch, stop_signal)
            if self._release_group is not None:  # the ranks left out may go
                dist.barrier(group=self._release_group)
            return state
        finally:
            for sig, prev in prev_handlers.items():
                signal.signal(sig, prev)
            torch.autograd.set_detect_anomaly(anomaly)
            if writer is not None:
                writer.close()

    def _fit_loop(self, state, data_iter, val_batches, writer, history, start_epoch,
                  stop_signal):
        c = self.cfg
        timer = StepTimer()
        diverged_evals = 0
        resume_offset = state.step % c.steps_per_epoch
        for epoch in range(start_epoch, c.num_epochs):
            epoch_metrics: list[dict] = []
            n_steps = c.steps_per_epoch
            if epoch == start_epoch and resume_offset:
                n_steps -= resume_offset
            for _ in range(n_steps):
                try:
                    batch = next(data_iter)
                except StopIteration:
                    break
                batch = torch.as_tensor(batch)
                accum = 1 if self.use_gan else c.accum_steps
                batch = self._local_batch(batch, accum).to(self.device)
                metrics = self.step_fn(state, batch)
                timer.tick(c.batch_size)
                step = state.step
                if c.save_every_steps and step % c.save_every_steps == 0:
                    self.save(state, epoch)
                if step % c.log_every == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    host["images_per_sec"] = timer.images_per_sec
                    writer.scalars(step, host)
                    history.append(step, host, kind="train")
                    epoch_metrics.append(host)
                    print(f"[trainer] epoch {epoch} step {step} loss {host['total']:.4f} "
                          f"({host['images_per_sec']:.1f} img/s)")
                if c.eval_every_steps and val_batches and step % c.eval_every_steps == 0:
                    val = self.evaluate(state, val_batches)
                    writer.scalars(step, val)
                    history.append(step, val, kind="val")
                    ema_str = (f" ema {val['val_psnr_ema']:.2f}"
                               if "val_psnr_ema" in val else "")
                    print(f"[trainer] epoch {epoch} step {step} val_psnr "
                          f"{val['val_psnr']:.2f} dB{ema_str} val_ssim {val['val_ssim']:.4f}")
                    sel = self._selection_psnr(val)
                    if c.keep_best and sel > self._best_psnr:
                        self._best_psnr = sel
                        self.save(state, epoch, best=True, val=val)
                    # The breaker watches the raw PSNR: an EMA lags a collapse.
                    raw = val.get("val_psnr", sel)
                    self._best_raw_psnr = max(self._best_raw_psnr, raw)
                    if (c.divergence_halt_db > 0 and np.isfinite(self._best_raw_psnr)
                            and raw < self._best_raw_psnr - c.divergence_halt_db):
                        diverged_evals += 1
                        if diverged_evals >= c.divergence_patience:
                            self.save(state, epoch)
                            print(f"[trainer] DIVERGENCE HALT: raw val PSNR {raw:.2f} dB "
                                  f"has sat more than {c.divergence_halt_db:.1f} dB below "
                                  f"the best ({self._best_raw_psnr:.2f} dB) for "
                                  f"{diverged_evals} consecutive evals. Halting; resume "
                                  "from checkpoints_best/ with adjusted hyperparameters.")
                            return state
                    else:
                        diverged_evals = 0
                if stop_signal[0] is not None:
                    break
            if stop_signal[0] is not None:
                self.save(state, epoch)
                print(f"[trainer] stopped by signal {stop_signal[0]} at step "
                      f"{state.step}; checkpoint saved, resume with the same --output_dir")
                break
            if epoch_metrics:
                avg = {f"epoch_avg/{k}": float(np.mean([m[k] for m in epoch_metrics]))
                       for k in epoch_metrics[0]}
                writer.scalars(state.step, avg)
                print(f"[trainer] epoch {epoch} done: avg loss {avg['epoch_avg/total']:.4f} "
                      f"over {len(epoch_metrics)} log points")
            if (epoch + 1) % c.save_every_epochs == 0 or epoch == c.num_epochs - 1:
                self.save(state, epoch)
        return state

    def save(self, state: TrainState, epoch: int, best: bool = False,
             val: dict | None = None) -> None:
        """Checkpoint under checkpoints/ (newest 3 kept), or with best=True
        under checkpoints_best/ (1 kept, val metrics beside it). The config
        is saved with the inference dispatch: 'auto_train' is a training
        policy, not architecture."""
        ckpt_dir = os.path.join(self.cfg.output_dir,
                                "checkpoints_best" if best else "checkpoints")
        payload = {"model": self._whole(state.model),
                   "optimizer": state.optimizer.state_dict(), "step": state.step}
        if state.ema is not None:
            payload["ema"] = (state.ema if self.placement is None else
                              self.placement.full_state(state.ema.items()))
        if state.vf_proj is not None:
            payload["vf_proj"] = self._whole(state.vf_proj, "vf_proj.")
        if self.use_gan and self._disc_state is not None:
            d = self._disc_state
            payload.update(disc_model=d.model.state_dict(),
                           disc_optimizer=d.optimizer.state_dict(), disc_step=d.step)
        saved_cfg = self.model_config
        if saved_cfg.attention_impl == "auto_train":
            saved_cfg = saved_cfg.replace(attention_impl="auto")
        if is_primary():
            save_checkpoint(ckpt_dir, state.step, payload, epoch=epoch, config=saved_cfg,
                            max_to_keep=1 if best else 3, metrics=val if best else None)
        if self.mesh is not None:
            dist.barrier(group=self._mesh_group)
        tag = " (new best)" if best else ""
        print(f"[trainer] saved checkpoint at step {state.step}{tag}")

