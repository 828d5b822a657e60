"""The training steps: forward, loss, backward, update (PyTorch port of
``training/train_step.py``): stage 1's and stage 2's GAN step.

- Params fp32, compute in the model's dtype (bf16): the model casts each
  weight at its use, so autograd returns fp32 gradients; no loss scaling
  (bf16 needs none).
- Gradient accumulation over ``accum_steps`` microbatches of one batch:
  each microbatch's backward adds into the fp32 ``.grad`` buffers, which are
  then scaled by 1 / accum_steps (the JAX step's fp32 scan sum); metrics are
  averaged the same way.
- ``grad_norm`` is the global norm of all gradients before the clip; the
  optimizer clips, skips non-finite steps and updates in place.
- The latent sample's noise comes from a ``torch.Generator`` seeded from
  (seed, step), so a resumed run draws what an unbroken one would.
- The VF term: with a teacher and the eager projection (``TrainState.vf_proj``,
  :func:`make_vf_proj_params`), the teacher sees the batch's images and the
  projection trains with the model (its gradients follow the model's, and
  the EMA covers it), in both steps, as in the JAX steps.
- The model is called deterministic (its dropout off), as the JAX steps
  call it (they pass only the 'sample' RNG).
- ``make_gan_train_step`` (stage 2): one generator update, then one
  discriminator update on fresh reconstructions, as the JAX package's
  ``make_gan_train_step`` computes them (its docstring has the history of
  each control: the warmup gate and ramp, the adaptive weight and its clamp,
  the disc loss floor, R1). Like the JAX step it takes the whole batch and
  ignores gradient accumulation.
- Under a mesh (``placement``, a ``parallel.Placement``), each rank takes
  its rows of the global batch (``parallel.shard_batch``: within each
  microbatch) and the step computes what the JAX step computes on the
  global batch: the gradients averaged over the data group in flat fp32
  buckets (both updates of the GAN step too); the latent noise drawn for
  the whole microbatch, each rank keeping its rows; the VF hinge on the
  whole batch's similarity; the adaptive weight from the last layer's
  gradients averaged over data; the disc loss floor on the global disc
  loss; metrics averaged over data (``mu_absmax``: the maximum over data of
  each microbatch, averaged); ``grad_norm`` over sharded gradients. Under
  FSDP the gathered weights are made once per forward and backward
  (``parametrize.cached``).
- Under a placement whose mesh has a context axis of more than one rank
  (context parallelism), the batch is this rank's rows of each image as
  well (``parallel.shard_rows``), the step runs under that context group
  (``parallel.context_parallel``), the L1 and KL terms are this rank's row
  means weighted by its share of the rows and LPIPS and the self-perceptual
  term each image's distance (``losses/lpips.py``, ``losses/vae_loss.py``,
  ``context.row_mean``). The VF teacher, the VF term and the discriminator
  read each image's rows gathered from the group (``context.whole_rows``,
  shares equal or not), so every context rank computes them whole; the
  gather's backward reduce-scatters. The gradients and metrics are averaged
  over the parameter peers (data x context): with the row means so
  weighted, the gradient of the global loss at every split. The GAN step's last-layer gradients and both
  updates' gradients are averaged over the peers too; its discriminator
  update runs on the gathered real and fresh images, and the fresh
  reconstruction under the context group. The latent noise is the global
  draw, sliced (``TransVAE.reparameterize``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.nn.utils import parametrize

from ..losses.vae_loss import LossWeights, discriminator_loss, transvae_loss
from ..models.transvae import adaptive_gan_weight, get_last_layer
from ..parallel.collectives import all_gather_cat, all_reduce_mean_, reduce_metrics
from ..parallel.context import context_parallel, whole_rows
from ..parallel.sharding import canonical_name
from .optim import _Chain


class VFProj(nn.Module):
    """The eager VF projection, latent D -> teacher C: ``kernel`` [D, C]
    (the JAX layout: the loss computes latent @ kernel) and ``bias`` [C]."""

    def __init__(self, latent_dim: int, dino_dim: int, *, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(latent_dim, dino_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dino_dim, device=device))


def make_vf_proj_params(latent_dim: int, dino_dim: int, generator: torch.Generator,
                        device=None) -> VFProj:
    """The VF projection made eagerly, so the optimizer has it from step 0:
    kernel N(0, 1) / sqrt(D) drawn from ``generator``, bias 0 (the JAX
    ``make_vf_proj_params``; its draw is JAX's own stream)."""
    proj = VFProj(latent_dim, dino_dim, device=device)
    with torch.no_grad():
        proj.kernel.normal_(generator=generator).div_(latent_dim ** 0.5)
    return proj


@dataclasses.dataclass
class TrainState:
    """What a step carries: the step count, the model (its parameters), the
    optimizer (its moments and counts), with EMA on the shadow parameters by
    name, and with a VF teacher the projection."""

    step: int
    model: torch.nn.Module
    optimizer: _Chain
    ema: dict[str, torch.Tensor] | None = None
    vf_proj: VFProj | None = None


def named_trainables(model: torch.nn.Module, vf_proj: VFProj | None = None
                     ) -> list[tuple[str, torch.Tensor]]:
    """The parameters a step trains, by name: the model's, then
    ``vf_proj.kernel`` and ``vf_proj.bias``. An FSDP-split weight is its
    local slice, under its state_dict key (``parallel.canonical_name``)."""
    named = [(canonical_name(n), p) for n, p in model.named_parameters()]
    if vf_proj is not None:
        named += [(f"vf_proj.{canonical_name(n)}", p) for n, p in vf_proj.named_parameters()]
    return named


def _gathered(placement):
    """Under FSDP, each gathered weight made once per use of the context."""
    if placement is not None and placement.mode == "fsdp":
        return parametrize.cached()
    return contextlib.nullcontext()


def _context(placement):
    """Under context parallelism the placement's context group, ambient."""
    if placement is not None and placement.context_size > 1:
        return context_parallel(placement.mesh)
    return contextlib.nullcontext()


def _rows(placement, rows: int) -> tuple[int, int] | None:
    """(first, total) of this rank's ``rows`` in the whole (micro)batch."""
    if placement is None:
        return None
    return placement.data_rank * rows, rows * placement.data_size


def _reduce(placement, metrics: dict, max_keys=()) -> dict:
    if placement is None:
        return metrics
    return reduce_metrics(metrics, placement.peer_group, max_keys)


def init_ema(model: torch.nn.Module, vf_proj: VFProj | None = None
             ) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in named_trainables(model, vf_proj)}


@torch.no_grad()
def _ema_update(ema_decay: float, ema: dict, named: list) -> None:
    """ema = decay * ema + (1 - decay) * params, in place."""
    params = dict(named)
    names = list(ema)
    shadow = [ema[n] for n in names]
    torch._foreach_mul_(shadow, ema_decay)
    torch._foreach_add_(shadow, [params[n].detach() for n in names],
                        alpha=1.0 - ema_decay)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The latent noise generator of one optimizer step."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def loss_and_metrics(model, images_nhwc: torch.Tensor, weights: LossWeights,
                     lpips_params: dict | None = None, sample: bool = True,
                     generator: torch.Generator | None = None,
                     disc_apply: Callable | None = None, teacher_fn: Callable | None = None,
                     vf_proj: VFProj | None = None, perceptual_fn: Callable | None = None,
                     placement=None, noise: torch.Tensor | None = None):
    """(total loss, metrics) for one batch of [B, H, W, 3] images in [0, 1]:
    the model sees them in its compute dtype, the loss in fp32.
    ``disc_apply`` (NCHW images in [0, 1] -> logits) gives the GAN term;
    ``teacher_fn`` (NCHW images -> features) and ``vf_proj`` the VF term;
    ``perceptual_fn`` takes the LPIPS slot (``make_self_perceptual``).
    ``placement``: the batch is this rank's rows (see the module docstring).
    ``noise``: the latent noise of the whole (micro)batch, in the place of a
    draw from ``generator`` (``TransVAE.reparameterize``'s ``eps``)."""
    target = images_nhwc.permute(0, 3, 1, 2)
    x = target.to(model.config.compute_dtype)
    recon, mu, logvar = model(x, sample=sample, generator=generator,
                              noise_rows=_rows(placement, x.shape[0]), eps=noise)
    dino = teacher_fn(whole_rows(target)) if teacher_fn is not None else None
    proj = (vf_proj.kernel, vf_proj.bias) if vf_proj is not None else None
    losses = transvae_loss(recon, target, mu, logvar, weights, lpips_params=lpips_params,
                           perceptual_fn=perceptual_fn, vf_proj=proj,
                           dino_features=dino, disc_apply=disc_apply,
                           data_group=None if placement is None else placement.data_group)
    metrics = dict(losses)
    metrics["recon_finite_frac"] = torch.isfinite(recon).float().mean()
    # A context rank past the end of an uneven latent split holds no rows.
    metrics["mu_absmax"] = torch.cat([mu.detach().abs().flatten().float(),
                                      mu.new_zeros(1, dtype=torch.float32)]).max()
    return losses["total"], metrics


def compute_grads(model, batch: torch.Tensor, weights: LossWeights,
                  lpips_params: dict | None = None, accum_steps: int = 1,
                  sample: bool = True, generator: torch.Generator | None = None,
                  teacher_fn: Callable | None = None, vf_proj: VFProj | None = None,
                  perceptual_fn: Callable | None = None, placement=None,
                  noise: list[torch.Tensor] | None = None
                  ) -> tuple[list[torch.Tensor], dict]:
    """fp32 gradients (one per parameter of :func:`named_trainables`, in its
    order) averaged over ``accum_steps`` microbatches of ``batch``, and the
    averaged metrics. ``placement``: ``batch`` is this rank's rows, and the
    gradients and metrics are averaged over the parameter peers (the data
    group; data x context under context parallelism). ``noise``: one latent
    noise tensor of each whole microbatch, in the place of the draws from
    ``generator``."""
    b = batch.shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
    params = [p for _, p in named_trainables(model, vf_proj)]
    for p in params:
        p.grad = None
    micro = b // accum_steps
    sums: dict[str, torch.Tensor] = {}
    maxima = []
    for i in range(accum_steps):
        with _gathered(placement), _context(placement):
            loss, metrics = loss_and_metrics(model, batch[i * micro:(i + 1) * micro],
                                             weights, lpips_params, sample, generator,
                                             teacher_fn=teacher_fn, vf_proj=vf_proj,
                                             perceptual_fn=perceptual_fn, placement=placement,
                                             noise=None if noise is None else noise[i])
            loss.backward()
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach().float()
        maxima.append(metrics["mu_absmax"])
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for p in params:
        p.grad = None
    if accum_steps > 1:
        torch._foreach_mul_(grads, 1.0 / accum_steps)
    metrics = {k: v / accum_steps for k, v in sums.items()}
    if placement is not None:
        all_reduce_mean_(grads, placement.peer_group)
        metrics["mu_absmax"] = torch.stack(maxima)
        metrics = _reduce(placement, metrics, max_keys=("mu_absmax",))
    return grads, metrics


def global_norm(tensors: list[torch.Tensor], placement=None,
                names: list[str] | None = None) -> torch.Tensor:
    """The L2 norm of all ``tensors``; with a ``placement``, of the whole
    tensors that ``names`` place there."""
    if placement is not None:
        return placement.norm(tensors, names)
    return torch.stack(torch._foreach_norm(tensors)).norm()


def make_train_step(weights: LossWeights = LossWeights(),
                    lpips_params: dict | None = None, accum_steps: int = 1,
                    ema_decay: float | None = None, seed: int = 0,
                    sample: bool = True, teacher_fn: Callable | None = None,
                    perceptual_fn: Callable | None = None, placement=None) -> Callable:
    """fn(state, batch) -> metrics: one optimizer step on ``batch``
    ([B, H, W, 3] in [0, 1] on the model's device; with ``placement`` this
    rank's rows of the global batch, ``parallel.shard_batch`` with
    ``accum_steps``), updating ``state`` in place. Metrics stay on the
    device (one host sync per step, the optimizer's finiteness check)."""

    def train_step(state: TrainState, batch: torch.Tensor) -> dict:
        model = state.model
        gen = step_generator(seed, state.step, batch.device)
        grads, metrics = compute_grads(model, batch, weights, lpips_params,
                                       accum_steps, sample, gen, teacher_fn,
                                       state.vf_proj, perceptual_fn, placement)
        metrics["grad_norm"] = global_norm(
            grads, placement, [n for n, _ in named_trainables(model, state.vf_proj)])
        state.optimizer.step(grads)
        if ema_decay is not None:
            _ema_update(ema_decay, state.ema, named_trainables(model, state.vf_proj))
        state.step += 1
        return metrics

    return train_step


def _grads(loss: torch.Tensor, params: list[torch.Tensor],
           retain_graph: bool = False) -> list[torch.Tensor]:
    """d loss / d params; zeros for a parameter the loss does not reach."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    got = torch.autograd.grad(loss, params, retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(got, params)]


def gan_generator_grads(model, disc, batch: torch.Tensor, weights: LossWeights,
                        lpips_params: dict | None = None, gan_scale: float = 1.0,
                        adaptive_weight: bool = False, adaptive_max: float = 1e4,
                        sample: bool = True, generator: torch.Generator | None = None,
                        teacher_fn: Callable | None = None, vf_proj: VFProj | None = None,
                        perceptual_fn: Callable | None = None, placement=None
                        ) -> tuple[list[torch.Tensor], dict]:
    """The generator's half of the GAN step: fp32 gradients of its loss for
    every parameter of :func:`named_trainables` (a frozen encoder's too, for
    the grad norm) and the metrics.

    ``gan_scale`` gates the adversarial term: metrics['gan'] already holds
    weights.gan, and total - (1 - gan_scale) * gan removes the generator's
    pull while the discriminator warms up. With ``adaptive_weight`` the
    term is rescaled by VQGAN's rule, the norms of the gradients of l1 +
    lpips and of gan with respect to the decoder's last conv weight, taken
    on the same graph: total = l1 + lpips + kl + vf + gan_scale * w * gan.
    ``placement``: ``batch`` is this rank's rows; the last layer's gradients,
    the gradients and the metrics are averaged over the parameter peers."""
    params = [p for _, p in named_trainables(model, vf_proj)]
    with _gathered(placement), _context(placement):
        total, metrics = loss_and_metrics(model, batch, weights, lpips_params, sample,
                                          generator, disc_apply=disc, teacher_fn=teacher_fn,
                                          vf_proj=vf_proj, perceptual_fn=perceptual_fn,
                                          placement=placement)
        total = total - (1.0 - gan_scale) * metrics["gan"]
        metrics["gan_scale"] = torch.tensor(gan_scale, dtype=torch.float32,
                                            device=batch.device)
        if adaptive_weight and weights.gan > 0:
            last = [get_last_layer(model)]
            rec = metrics["l1"] + metrics["lpips"]
            last_grads = [_grads(rec, last, retain_graph=True)[0],
                          _grads(metrics["gan"], last, retain_graph=True)[0]]
            if placement is not None:
                all_reduce_mean_(last_grads, placement.peer_group)
            w = adaptive_gan_weight(*last_grads, max_weight=adaptive_max)
            total = rec + metrics["kl"] + metrics["vf"] + gan_scale * w * metrics["gan"]
            metrics["adaptive_gan_weight"] = w
        metrics["total"] = total
        grads = _grads(total, params)
    metrics = {k: v.detach().float() for k, v in metrics.items()}
    if placement is not None:
        all_reduce_mean_(grads, placement.peer_group)
        metrics["mu_absmax"] = metrics["mu_absmax"][None]
        metrics = _reduce(placement, metrics, max_keys=("mu_absmax",))
    return grads, metrics


def discriminator_grads(disc, real: torch.Tensor, fake: torch.Tensor,
                        kind: str = "hinge", r1_gamma: float = 0.0, placement=None
                        ) -> tuple[list[torch.Tensor], dict]:
    """The discriminator's half of the GAN step on NCHW fp32 images in [0, 1]:
    the gradients of its loss (``kind``, plus with ``r1_gamma`` the R1
    penalty 0.5 * gamma * mean_b ||d sum(D(real)) / d real||^2, a double
    backward) for every parameter of ``disc``, and the metrics. ``disc_loss``
    is the loss before R1 (what the floor reads). One forward of the real
    images serves the loss and R1: the JAX step's two are the same function
    of the same input. ``placement``: the images are this rank's rows; under
    a context axis each image's rows are gathered first (every context rank
    runs the discriminator on the whole images; the R1 leaf is the gathered
    real). The gradients and the metrics are averaged over the parameter
    peers, which also keeps the discriminator bit-identical on every rank."""
    params = list(disc.parameters())
    real, fake = real.detach(), fake.detach()
    if placement is not None and placement.context_size > 1:
        real = all_gather_cat(real, 2, placement.context_group)
        fake = all_gather_cat(fake, 2, placement.context_group)
    if r1_gamma > 0:
        real.requires_grad_(True)
    real_logits = disc(real)
    fake_logits = disc(fake)
    loss = discriminator_loss(real_logits, fake_logits, kind)
    metrics = {"disc_loss": loss.detach(), "disc_real_mean": real_logits.detach().mean(),
               "disc_fake_mean": fake_logits.detach().mean()}
    if r1_gamma > 0:
        (g,) = torch.autograd.grad(real_logits.float().sum(), real, create_graph=True)
        r1 = g.square().flatten(1).sum(dim=-1).mean()
        loss = loss + 0.5 * r1_gamma * r1
        metrics["disc_r1"] = r1.detach()
    grads = _grads(loss, params)
    if placement is not None:
        all_reduce_mean_(grads, placement.peer_group)
    return grads, _reduce(placement, metrics)


def make_gan_train_step(weights: LossWeights = LossWeights(),
                        lpips_params: dict | None = None, disc_loss_kind: str = "hinge",
                        adaptive_weight: bool = False, ema_decay: float | None = None,
                        gan_warmup_steps: int = 0, gan_ramp_steps: int = 1,
                        adaptive_max: float = 1e4, disc_loss_floor: float = 0.0,
                        r1_gamma: float = 0.0, seed: int = 0,
                        teacher_fn: Callable | None = None,
                        perceptual_fn: Callable | None = None, placement=None,
                        disc_placement=None) -> Callable:
    """fn(gen_state, disc_state, batch) -> metrics: one generator update and
    one discriminator update on ``batch`` ([B, H, W, 3] in [0, 1]), both
    states updated in place.

    - gan_scale = clip((disc_step - gan_warmup_steps + 1) / max(ramp, 1), 0,
      1), read from the discriminator's step before its update: the gate is
      stage-2 relative even when the generator resumes at step 6000.
    - The generator's update (its optimizer partitions a frozen encoder),
      then its EMA.
    - The discriminator trains on fresh reconstructions: a second forward
      with the updated parameters, without grad, drawing the same latent
      noise as the generator's forward (its generator is rebuilt from the
      same seed and step); fake = sigmoid(recon) in fp32.
    - ``disc_loss_floor``: while disc_loss is below it, D's gradients are
      multiplied by 0 and its optimizer still steps, so Adam's moments move
      D's parameters; mirrored from the JAX step, not fixed.
    - ``placement`` / ``disc_placement`` (the generator's and the
      discriminator's; the latter replicates every parameter): ``batch`` is
      this rank's rows (see the module docstring).
    """

    def train_step(gen_state: TrainState, disc_state: TrainState,
                   batch: torch.Tensor) -> dict:
        model, disc, step = gen_state.model, disc_state.model, gen_state.step
        past_gate = float(disc_state.step - gan_warmup_steps + 1)
        gan_scale = min(max(past_gate / max(gan_ramp_steps, 1), 0.0), 1.0)

        grads, metrics = gan_generator_grads(
            model, disc, batch, weights, lpips_params, gan_scale, adaptive_weight,
            adaptive_max, generator=step_generator(seed, step, batch.device),
            teacher_fn=teacher_fn, vf_proj=gen_state.vf_proj, perceptual_fn=perceptual_fn,
            placement=placement)
        metrics["grad_norm"] = global_norm(
            grads, placement, [n for n, _ in named_trainables(model, gen_state.vf_proj)])
        gen_state.optimizer.step(grads)
        del grads
        if ema_decay is not None:
            _ema_update(ema_decay, gen_state.ema, named_trainables(model, gen_state.vf_proj))
        gen_state.step += 1

        real = batch.permute(0, 3, 1, 2).float().contiguous()
        with torch.no_grad(), _gathered(placement), _context(placement):
            recon = model(real.to(model.config.compute_dtype), sample=True,
                          generator=step_generator(seed, step, batch.device),
                          noise_rows=_rows(placement, real.shape[0]))[0]
            fake = torch.sigmoid(recon.float())
        del recon
        d_grads, d_metrics = discriminator_grads(disc, real, fake, disc_loss_kind, r1_gamma,
                                                 disc_placement)
        if disc_loss_floor > 0:
            d_scale = (d_metrics["disc_loss"] >= disc_loss_floor).float()
            torch._foreach_mul_(d_grads, d_scale)
            d_metrics["disc_update_scale"] = d_scale
        disc_state.optimizer.step(d_grads)
        disc_state.step += 1
        return {**metrics, **d_metrics}

    return train_step


def make_eval_step(model, weights: LossWeights = LossWeights(),
                   lpips_params: dict | None = None) -> Callable:
    """fn(batch) -> (reconstructions in [0, 1] NCHW fp32, losses): the
    deterministic forward (decoding the mean)."""

    @torch.no_grad()
    def eval_step(batch: torch.Tensor):
        target = batch.permute(0, 3, 1, 2)
        recon, mu, logvar = model(target.to(model.config.compute_dtype), sample=False)
        losses = transvae_loss(recon, target, mu, logvar, weights,
                               lpips_params=lpips_params)
        return torch.sigmoid(recon.float()), losses

    return eval_step
