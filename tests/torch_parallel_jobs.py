"""Shared harness of the port's multi-rank tests (tests/test_torch_parallel*.py):
a pool of rank processes and the jobs they run, JAX-free (the ranks import
only torch and deepl_project_tpu_torch).

:class:`RankPool` starts ``size`` processes once (``torch.multiprocessing``,
spawn) and runs each job on the first ``world`` of them: every rank joins a
fresh gloo process group through a ``file://`` store under the test's
``tmp_path`` (no TCP port, so concurrent test workers never clash), runs
the job function named by module and name, and leaves the group. A rank's
exception fails the job with its traceback. Each job carries its number and
each answer the same number back, so a job reads only its own ranks'
answers. A job whose ranks do not all answer within JOB_TIMEOUT_S of the
last answer, or whose rank process dies, fails with what the ranks said,
and the pool's processes are stopped and started anew before the next job:
a rank still busy with (or stuck in) a failed job never serves the next.

Each job has a single-process twin in this module (``*_reference``): the
same micro model (fp32, seeded), batches and step on one process, which the
tests hold the ranks' results to.
"""

from __future__ import annotations

import importlib
import itertools
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The micro model of tests/test_torch_training.py: 4 stages (2 CNN, 2
# transformer: 2 heads at C=32, 4 heads at C=64), no DC path, fp32.
VARIANT = "tiny_f8d16"
MICRO = dict(depths=(1, 1, 1, 1), base_dims=(16, 16, 32, 64), latent_dim=4,
             head_dim=16, dtype="float32", attention_impl="auto_train", use_dc_path=False)
RES = 32
SEED = 1
# FSDP's size threshold for the micro model (the default 2**16 would split
# nothing): proj_in / proj_out / the FFN 1x1 convs and the larger convs.
FSDP_MIN = 1024
JOB_TIMEOUT_S = 120
# A rank process's start (spawn, imports) before it takes its first job.
START_TIMEOUT_S = 120


def _worker(rank: int, jobs, results) -> None:
    torch.set_num_threads(1)
    results.put((None, rank, True, None))  # started
    while True:
        job = jobs.get()
        if job is None:
            return
        job_id, module, name, world, store, args = job
        try:
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world)
            out = getattr(importlib.import_module(module), name)(*args)
        except BaseException:  # noqa: BLE001 -- handed to the test
            results.put((job_id, rank, False, traceback.format_exc()))
        else:
            results.put((job_id, rank, True, out))
            _leave_together()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
                os.environ.pop(key, None)


def _leave_together() -> None:
    """Hold this rank's group until every rank is past its job. A rank that
    left while a peer still connected a group of the job (the default one,
    or a DeviceMesh's subgroups) failed the peer's connect ("Connection
    closed by peer"), and a third rank then waited for that peer's share of
    another subgroup until the store timed out."""
    if not dist.is_initialized():  # the job left the group itself
        return
    try:
        dist.barrier()
    except RuntimeError:
        pass  # a peer left the group in its job (a failed follower): nothing to hold


class RankPool:
    """``size`` rank processes, started once, running jobs of 1..size ranks."""

    def __init__(self, size: int = 4):
        self.size = size
        self._ids = itertools.count()
        self._start()

    def _start(self) -> None:
        """Start the rank processes on fresh queues and wait until each has
        started."""
        ctx = mp.get_context("spawn")
        self.jobs = [ctx.Queue() for _ in range(self.size)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, args=(r, self.jobs[r], self.results),
                                  daemon=True) for r in range(self.size)]
        for p in self.procs:
            p.start()
        started = set()
        deadline = time.monotonic() + START_TIMEOUT_S
        while len(started) < self.size:
            try:
                _, rank, _, _ = self.results.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                self._stop()
                raise TimeoutError(f"ranks {sorted(set(range(self.size)) - started)} did not "
                                   f"start within {START_TIMEOUT_S} s") from None
            started.add(rank)

    def _stop(self) -> None:
        """Kill the rank processes and drop their queues (a queue a killed
        process wrote to may be left half written)."""
        for p in self.procs:
            p.kill()
        for p in self.procs:
            p.join()
        for q in (*self.jobs, self.results):
            q.cancel_join_thread()
            q.close()

    def run(self, fn, world: int, tmp_path, *args) -> list:
        """``fn(*args)`` on ranks 0..world-1; their results in rank order."""
        job = next(self._ids)
        store = os.path.join(str(tmp_path), f"store_{job}")
        for r in range(world):
            self.jobs[r].put((job, fn.__module__, fn.__name__, world, store, args))
        out = [None] * world
        errors = []
        waiting = set(range(world))
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while waiting:
            try:
                got, rank, ok, value = self.results.get(
                    timeout=min(0.25, max(deadline - time.monotonic(), 0)))
            except queue.Empty:
                dead = {r: self.procs[r].exitcode for r in sorted(waiting)
                        if not self.procs[r].is_alive()}
                if not dead and time.monotonic() < deadline:
                    continue
                self._stop()
                self._start()
                why = (f"rank processes exited {dead}" if dead
                       else f"no answer within {JOB_TIMEOUT_S} s")
                raise TimeoutError(
                    "\n".join([f"{fn.__name__}: ranks {sorted(waiting)} did not answer ({why}; "
                               "the pool's ranks were started anew)", *errors]))
            if got != job or rank not in waiting:  # an answer of an earlier job
                continue
            waiting.discard(rank)
            deadline = time.monotonic() + JOB_TIMEOUT_S
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()


def answer(tag, delay: float = 0.0, exit_rank: int | None = None) -> tuple:
    """The harness's own job: (tag, rank, pid) after ``delay`` seconds; the
    process of rank ``exit_rank`` exits instead of answering."""
    if dist.get_rank() == exit_rank:
        os._exit(3)
    time.sleep(delay)
    return tag, dist.get_rank(), os.getpid()


# -- tolerances ----------------------------------------------------------------
LR = 1e-4
GRAD_TOL = 1e-5
PARAM_TOL = 1e-5


def _max(d: dict) -> float:
    return max(float(v.abs().max()) for v in d.values())


def check_grads(want: dict, got: dict) -> None:
    err = max(float((v - got[k]).abs().max()) for k, v in want.items())
    assert err <= GRAD_TOL * _max(want), err


def check_params(grads: dict, want: dict, got: dict, steps: int) -> None:
    """Parameters after ``steps`` updates within PARAM_TOL of the largest;
    one whose single-process gradient lies within GRAD_TOL of zero (its
    updates' signs not fixed by the gradient check) within the largest move
    of ``steps`` AdamW / Adafactor updates, 2 x steps x lr."""
    gmax = _max(grads)
    noise = {k for k, g in grads.items() if float(g.abs().max()) <= GRAD_TOL * gmax}
    pmax = _max(want)
    for k, v in want.items():
        err = float((v - got[k]).abs().max())
        assert err <= (2 * steps * LR if k in noise else PARAM_TOL * pmax), (k, err)


# -- the model, batches and steps ---------------------------------------------
def micro_config(**kw):
    from deepl_project_tpu_torch import get_config

    return get_config(VARIANT, **{**MICRO, **kw})


def build_model(seed: int = SEED, **kw):
    from deepl_project_tpu_torch.models import TransVAE, init_weights

    with torch.device("meta"):
        model = TransVAE(micro_config(**kw))
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def batches(n: int, batch: int, seed: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.random((batch, RES, RES, 3), np.float32) for _ in range(n)]


def _mesh(model_size: int):
    from deepl_project_tpu_torch.parallel import create_mesh

    return create_mesh(model=model_size)


def _place(model, mode: str, model_size: int, vf_proj=None):
    """(placement, mesh) of ``model`` (and ``vf_proj``) on a fresh mesh, or
    (None, None) for the single-process twin (``mode`` None)."""
    if mode is None:
        return None, None
    from deepl_project_tpu_torch.parallel import shard_params

    mesh = _mesh(model_size)
    placement = shard_params(mesh, model, mode, FSDP_MIN)
    if vf_proj is not None:
        shard_params(mesh, vf_proj, mode, FSDP_MIN, prefix="vf_proj.", placement=placement)
    return placement, mesh


def _whole(placement, named) -> dict:
    if placement is None:
        return {n: t.detach().clone() for n, t in named}
    return placement.full_state(named)


def _weights(**kw):
    from deepl_project_tpu_torch.losses import LossWeights

    return LossWeights(**{"lpips": 0.0, "vf": 0.0, "gan": 0.0, "kl": 1e-2, **kw})


def stub_teacher(images: torch.Tensor) -> torch.Tensor:
    """A VF teacher whose features follow the image: [B, 8, 4, 4] from 8x8
    average pools of the channels and their squares (a latent can align with
    some images and not others, so ranks' local hinges differ)."""
    p = torch.nn.functional.avg_pool2d(images, 8)
    return torch.cat([p, p.square(), p[:, :2] - 0.5], 1)


stub_teacher.feature_dim = 8


def train(mode, model_size, accum, data, steps=2, weights=None, opt=None,
          teacher=False, model_kw=None, fuse_qkv=False) -> dict:
    """``steps`` optimizer steps of the micro model on global batches
    ``data`` (the first step's gradients by ``compute_grads`` first); under
    ``mode`` on the process group's ranks, else on one process. Returns the
    first gradients and the final parameters whole, and every step's
    metrics. ``model_kw``: config fields over the micro model's;
    ``fuse_qkv``: every attention module folds its QKV LayerNorms."""
    from deepl_project_tpu_torch.parallel import shard_batch
    from deepl_project_tpu_torch.training.optim import make_optimizer
    from deepl_project_tpu_torch.training.train_step import (
        TrainState, compute_grads, make_train_step, make_vf_proj_params, named_trainables,
        step_generator)

    from deepl_project_tpu_torch.ops.attention import AttentionRoPE

    model = build_model(**(model_kw or {}))
    for m in model.modules():
        if isinstance(m, AttentionRoPE):
            m.fuse_qkv = fuse_qkv
    vf_proj = (make_vf_proj_params(4, 8, torch.Generator().manual_seed(7)) if teacher
               else None)
    placement, mesh = _place(model, mode, model_size, vf_proj)
    named = named_trainables(model, vf_proj)
    w = _weights(**(weights or {}))
    tfn = stub_teacher if teacher else None
    local = [torch.as_tensor(shard_batch(mesh, b, accum)) for b in data]
    grads, _ = compute_grads(model, local[0], w, accum_steps=accum,
                             generator=step_generator(0, 0, "cpu"), teacher_fn=tfn,
                             vf_proj=vf_proj, placement=placement)
    first = _whole(placement, zip([n for n, _ in named], grads))
    optimizer = make_optimizer(named, learning_rate=1e-4, warmup_steps=1,
                               placement=placement, **(opt or {}))
    state = TrainState(0, model, optimizer, vf_proj=vf_proj)
    step = make_train_step(w, accum_steps=accum, seed=0, teacher_fn=tfn, placement=placement)
    metrics = []
    for b in local[:steps]:
        m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        metrics[-1]["finite"] = optimizer.last_finite
    return {"grads": first, "params": _whole(placement, named), "metrics": metrics}


def train_reference(accum, data, **kw) -> dict:
    return train(None, 1, accum, data, **kw)


def nan_step(mode, model_size, data) -> dict:
    """One optimizer step whose gradients hold a NaN on one rank's shard
    (the single-process twin: in the same whole tensor): the step must be
    skipped everywhere and change nothing."""
    from deepl_project_tpu_torch.parallel import shard_batch
    from deepl_project_tpu_torch.training.optim import make_optimizer
    from deepl_project_tpu_torch.training.train_step import compute_grads, named_trainables

    model = build_model()
    placement, mesh = _place(model, mode, model_size)
    named = named_trainables(model)
    before = _whole(placement, named)
    opt = make_optimizer(named, learning_rate=1e-4, warmup_steps=1, placement=placement,
                         optimizer="adafactor")
    grads, _ = compute_grads(model, torch.as_tensor(shard_batch(mesh, data[0])), _weights(),
                             sample=False, placement=placement)
    i = next(i for i, (n, _) in enumerate(named) if n.endswith("proj_out.weight"))
    if placement is None or placement.model_rank == placement.model_size - 1:
        grads[i].view(-1)[-1] = float("nan")
    applied = opt.step(grads)
    return {"applied": applied, "params": _whole(placement, named),
            "before": before, "skipped": opt.notfinite_count}


def forward_tensor(model_size, data) -> dict:
    """No-grad forwards of the micro model under 'tensor' at attention
    'auto' (the inference dispatch: the local heads take the composable
    route), with the route counts of the ranks' forward."""
    from deepl_project_tpu_torch.ops import attention
    from deepl_project_tpu_torch.parallel import shard_params

    model = build_model(attention_impl="auto")
    if model_size:
        shard_params(_mesh(model_size), model, "tensor")
    attention.reset_route_counts()
    with torch.no_grad():
        x = torch.as_tensor(data[0]).permute(0, 3, 1, 2)
        recon, mu, _ = model(x)
    return {"recon": recon, "mu": mu, "routes": attention.route_counts()}


def gan(mode, model_size, data, steps=2, floor=2.0, dtype="float32") -> dict:
    """``steps`` GAN steps (adaptive weight, R1, the disc loss floor: at 2.0
    the hinge loss at init, ~1.98 then ~2.01, blocks the first update and
    lets the second through) of the micro model computing in ``dtype`` and
    a PatchGAN; the generator's gradients on the first batch (before any
    step), the metrics and the final parameters whole."""
    from deepl_project_tpu_torch.models.discriminator import (PatchDiscriminator,
                                                              init_disc_weights)
    from deepl_project_tpu_torch.parallel import Placement, shard_batch
    from deepl_project_tpu_torch.training.optim import make_optimizer
    from deepl_project_tpu_torch.training.train_step import (TrainState,
                                                             gan_generator_grads,
                                                             make_gan_train_step,
                                                             named_trainables, step_generator)

    model = build_model(dtype=dtype)
    disc = PatchDiscriminator(base_channels=8, num_layers=2, dtype=torch.float32)
    init_disc_weights(disc, torch.Generator().manual_seed(5))
    placement, mesh = _place(model, mode, model_size)
    disc_placement = None if mesh is None else Placement(mesh)
    named = named_trainables(model)
    g = TrainState(0, model, make_optimizer(named, learning_rate=1e-4, warmup_steps=1,
                                            placement=placement))
    d = TrainState(0, disc, make_optimizer(disc.named_parameters(), learning_rate=1e-3,
                                           warmup_steps=0, placement=disc_placement))
    w = _weights(gan=0.1)
    grads, _ = gan_generator_grads(model, disc, torch.as_tensor(shard_batch(mesh, data[0])), w,
                                   adaptive_weight=True, adaptive_max=1e3,
                                   generator=step_generator(0, 0, "cpu"), placement=placement)
    first = _whole(placement, zip([n for n, _ in named], grads))
    step = make_gan_train_step(w, adaptive_weight=True, adaptive_max=1e3,
                               disc_loss_floor=floor, r1_gamma=1.0, seed=0,
                               placement=placement, disc_placement=disc_placement)
    metrics = []
    for b in data[:steps]:
        m = step(g, d, torch.as_tensor(shard_batch(mesh, b)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _whole(placement, named), "grads": first,
            "disc": {n: p.detach().clone() for n, p in disc.named_parameters()}}


def mesh_coordinates(data: int, model: int) -> tuple:
    from deepl_project_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=data, model=model)
    return dist.get_rank(), tuple(mesh.get_coordinate())


def vf_term(x: torch.Tensor, feats: torch.Tensor, kernel, bias, naive: bool) -> dict:
    """The VF term on this data rank's rows of (x, feats) and its gradient
    by x, whole; ``naive``: the hinge of this rank's own mean."""
    from deepl_project_tpu_torch.losses.vae_loss import vf_loss
    from deepl_project_tpu_torch.parallel import all_reduce_mean_, create_mesh, shard_batch

    mesh = create_mesh()
    group = mesh.get_group("data")
    lx = shard_batch(mesh, x).clone().requires_grad_(True)
    loss = vf_loss(lx, shard_batch(mesh, feats), kernel, bias,
                   data_group=None if naive else group)
    (gx,) = torch.autograd.grad(loss, lx)
    value = loss.detach().clone()
    all_reduce_mean_([value], group)
    # Each rank's gradient of its rows, averaged as the step averages
    # gradients: the rank's share of the mean over the data group.
    parts = [torch.empty_like(gx) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, gx / dist.get_world_size())
    return {"loss": float(value), "grad": torch.cat(parts)}


def fit(mode, model_size, out_dir, data, resume_only=False) -> dict:
    """Trainer.fit of the micro model (2 steps, a checkpoint) under a mesh
    of ``model_size`` and ``mode`` -- or, with ``resume_only``, the state
    restored from ``out_dir``'s checkpoint -- and the parameters whole."""
    from deepl_project_tpu_torch.parallel import sharding
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.train_step import named_trainables

    sharding.FSDP_MIN_SIZE = FSDP_MIN
    tc = TrainerConfig(batch_size=data[0].shape[0], accum_steps=1, warmup_steps=1,
                       num_epochs=1, steps_per_epoch=len(data), log_every=1,
                       resolution=RES, output_dir=out_dir, weights=_weights(),
                       save_every_epochs=1, seed=SEED, mesh_model=model_size,
                       param_sharding=mode, ema_decay=0.9)
    trainer = Trainer(micro_config(), tc, device="cpu")
    state = trainer.create_state()
    if resume_only:
        state, _ = trainer.maybe_resume(state)
    else:
        state = trainer.fit(iter(data), state=state)
    return {"params": _whole(trainer.placement, named_trainables(state.model)),
            "step": state.step, "optimizer": state.optimizer.state_dict(),
            "ema": _whole(trainer.placement, state.ema.items())}


def train_cli(argv: list, world: int) -> bool:
    """cli.train as torchrun starts it: RANK / WORLD_SIZE / LOCAL_RANK set,
    the process group already joined; the micro model in the place of the
    CLI's variant."""
    from deepl_project_tpu_torch.cli import train as cli

    from deepl_project_tpu_torch import get_config

    os.environ.update(RANK=str(dist.get_rank()), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(dist.get_rank()))
    cli.get_config = lambda *a, **kw: get_config(VARIANT, **{**kw, **MICRO})
    try:
        cli.main(argv)
    finally:
        cli.get_config = get_config
    return True


def collectives(x: torch.Tensor) -> dict:
    """Each collective of ``parallel.collectives`` on this rank's input
    (rank r holds x * (r + 1)) and the gradient of sum(output * w) by it,
    w = 1 + the output's index (so each entry's gradient is its own)."""
    from deepl_project_tpu_torch.parallel import collectives as col

    rank = dist.get_rank()
    group = dist.group.WORLD
    out = {}
    for name, fn in (("copy", lambda t: col.copy_to_group(t, group)),
                     ("reduce", lambda t: col.reduce_from_group(t, group)),
                     ("gather", lambda t: col.gather_from_group(t, 0, group)),
                     ("gather_reduce_grad",
                      lambda t: col.gather_from_group(t, 0, group, reduce_grad=True)),
                     ("scatter", lambda t: col.scatter_to_group(t, 0, group)),
                     ("reduce_scatter", lambda t: col.reduce_scatter(t, 0, group)),
                     ("global_mean", lambda t: col.global_mean(t, group))):
        xi = (x * (rank + 1)).requires_grad_(True)
        y = fn(xi)
        w = 1.0 + torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
        (g,) = torch.autograd.grad((y * w).sum(), xi)
        out[name] = (y.detach(), g)
    grads = [x * (rank + 1), x[:1] * (rank + 1)]
    col.all_reduce_mean_(grads, group, bucket_numel=x.numel())
    out["all_reduce_mean_"] = grads
    return out
