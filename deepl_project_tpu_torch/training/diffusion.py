"""Rectified-flow training and sampling for the latent DiT (PyTorch port of
``training/diffusion.py``).

    x_t = (1 - t) x0 + t eps,   target v = eps - x0,   L = ||v(x_t, t, y) - v||^2

Sampling integrates dx/dt = v from t = 1 (noise) down to t = 0 (data) with
Euler steps, with classifier-free guidance as one doubled batch against the
null class. Latents are [B, h, w, C] (channels last, as the JAX package's)
and normalised per channel by :class:`LatentStats`; images cross the public
functions as NHWC [0, 1] (numpy or tensors), and the tokenizer runs on NCHW
tensors inside.

Randomness: a step draws t, the noise and the label dropout from one
``torch.Generator`` seeded from (seed, step) (``train_step.step_generator``),
the counterpart of ``jax.random.fold_in(rng, state.step)``, so a resumed run
draws what an unbroken one draws. The JAX package's own draws are another
stream: the loss, the step and the sampler take ``t``, ``noise`` and the
initial ``z`` from the caller instead where given. The sampler's
``params`` (``dit_params`` where a function samples) is the DiT's weights:
None for the module's own, or a state_dict (the EMA shadow), run through
``torch.func.functional_call``.

Under a ``parallel.PipelinePlacement`` (the (data, pipe, expert) mesh of
the JAX dry run's phase 5) the step takes this rank's rows of the global
batch (``parallel.shard_batch``), makes the mesh's axes ambient (the blocks
pipeline over ``pipe`` for a config with ``pipeline_axis``; the Switch
FFN's experts split over ``expert``), draws t, the noise and the label
dropout for the whole batch and keeps this rank's rows (so it computes
what one process computes on the global batch), averages each gradient
over the ranks that hold its parameter, takes the global grad norm with
each parameter counted once, and lets the optimizer skip a non-finite step
on every rank together. It takes every global batch the JAX step takes:
a multiple of ``pipeline_microbatches`` that splits over the data ranks.
Each data rank pipelines its own rows, in ``pipeline_microbatches`` of
them where they divide, else its part of JAX's microbatches of the global
batch (``parallel.pipeline.microbatch_rows``). The DiT computes each row
alone (attention within an image; the Switch FFN's capacity is each
image's, ``ops/moe.py``), so the split does not change a result. Every
data rank holds as many rows, so the mean over data of each rank's mean
loss and gradient is the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
from torch.func import functional_call

from ..evaluation import _nchw, load_params
from ..ops.moe import collect_aux_losses
from ..parallel.mesh import use_axes
from .train_step import (TrainState, _ema_update, _grads, global_norm, named_trainables,
                         step_generator)


@dataclasses.dataclass
class LatentStats:
    """Per-channel latent normalization: z_norm = (z - mean) / std."""

    mean: torch.Tensor  # [C] fp32
    std: torch.Tensor   # [C] fp32

    @staticmethod
    def identity(channels: int, device=None) -> "LatentStats":
        return LatentStats(mean=torch.zeros(channels, device=device),
                           std=torch.ones(channels, device=device))

    @staticmethod
    def from_latents(z: torch.Tensor) -> "LatentStats":
        """Mean and std (ddof 0, plus 1e-6) over every axis but the last."""
        dims = tuple(range(z.dim() - 1))
        return LatentStats(mean=z.mean(dim=dims).float(),
                           std=(z.std(dim=dims, correction=0) + 1e-6).float())

    def normalize(self, z: torch.Tensor) -> torch.Tensor:
        return (z - self.mean) / self.std

    def denormalize(self, z: torch.Tensor) -> torch.Tensor:
        return z * self.std + self.mean


def _apply(model, params: Mapping[str, torch.Tensor] | None, *args, **kw) -> torch.Tensor:
    return model(*args, **kw) if params is None else functional_call(model, dict(params),
                                                                       args, kw)


def rectified_flow_loss(model, z0: torch.Tensor, labels: torch.Tensor,
                        generator: torch.Generator | None = None,
                        time_sampling: str = "logit_normal", *, t: torch.Tensor | None = None,
                        noise: torch.Tensor | None = None,
                        rows: tuple[int, int] | None = None) -> tuple[torch.Tensor, dict]:
    """Flow-matching MSE on normalized latents z0 [B, h, w, C]: (loss,
    metrics 'loss', 'v_norm' and, for a MoE model in the unrolled layout,
    'moe_aux' and 'total'). t, the noise and the label dropout come from
    ``generator`` in that order (t and the noise only where not given);
    ``rows`` = (first, total): z0 is rows of a batch of ``total``, whose
    draws are made whole and sliced."""
    b = z0.shape[0]
    first, total = (0, b) if rows is None else rows
    mine = slice(first, first + b)
    if t is None:
        if time_sampling == "logit_normal":
            # SD3 / LightningDiT: concentrates the steps at mid-noise levels.
            t = torch.sigmoid(torch.randn(total, generator=generator, device=z0.device))[mine]
        else:
            t = torch.rand(total, generator=generator, device=z0.device)[mine]
    if noise is None:
        noise = torch.randn((total,) + tuple(z0.shape[1:]), generator=generator,
                            device=z0.device)[mine]
    tb = t[:, None, None, None]
    z_t = (1.0 - tb) * z0 + tb * noise
    target = noise - z0
    v = model(z_t, t, labels, deterministic=False, generator=generator, rows=rows)
    loss = (v.float() - target).square().mean()
    metrics = {"loss": loss, "v_norm": v.square().mean().sqrt()}
    # The stacked layout (scan_blocks or pipeline_axis) keeps no router
    # loss (models/dit.py).
    if model.config.moe_experts > 1 and not model.config.stacked:
        aux = collect_aux_losses(model)
        metrics["moe_aux"] = aux
        loss = loss + model.config.moe_aux_weight * aux
        metrics["total"] = loss
    return loss, metrics


def make_dit_train_step(model, time_sampling: str = "logit_normal",
                        ema_decay: float | None = None, seed: int = 0,
                        placement=None) -> Callable:
    """fn(state, z0, labels, t=None, noise=None) -> metrics: one optimizer
    step (``state.optimizer``: ``make_optimizer(..., b2=0.95)``) on the
    NORMALIZED latent batch z0 [B, h, w, C], updating ``state`` in place,
    with ``grad_norm`` taken before the clip; with ``ema_decay`` the EMA
    shadow (``state.ema``) follows. Metrics stay on the device.
    ``placement`` (a ``parallel.PipelinePlacement``; the module docstring):
    z0, labels, t and the noise are this rank's rows of the global batch."""

    def step(state: TrainState, z0: torch.Tensor, labels: torch.Tensor,
             t: torch.Tensor | None = None, noise: torch.Tensor | None = None) -> dict:
        gen = step_generator(seed, state.step, z0.device)
        named = named_trainables(model)
        names = [n for n, _ in named]
        rows = None
        if placement is not None:
            rows = placement.rows(z0.shape[0])
        with use_axes(None if placement is None else placement.mesh):
            loss, metrics = rectified_flow_loss(model, z0, labels, gen, time_sampling,
                                                t=t, noise=noise, rows=rows)
            grads = _grads(loss, [p for _, p in named])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if placement is not None:
            placement.average_grads(grads, names)
            # v_norm is a root mean square: average its square.
            metrics["v_norm"] = metrics["v_norm"].square()
            metrics = placement.reduce_metrics(metrics)
            metrics["v_norm"] = metrics["v_norm"].sqrt()
        metrics["grad_norm"] = global_norm(grads, placement, names)
        state.optimizer.step(grads)
        if ema_decay is not None:
            _ema_update(ema_decay, state.ema, named)
        state.step += 1
        return metrics

    return step


def make_sampler(model, num_steps: int = 50, cfg_scale: float = 1.0,
                 num_classes: int = 1000) -> Callable:
    """Euler rectified-flow sampler: fn(labels, grid, channels,
    generator=None, z=None, params=None) -> normalized latents [B, grid,
    grid, channels] (fp32). The initial noise is ``z`` or drawn from
    ``generator``. With cfg_scale != 1 each step runs the conditional and
    the null-class branch as one doubled batch and extrapolates."""

    @torch.no_grad()
    def sample(labels: torch.Tensor, grid: int, channels: int,
               generator: torch.Generator | None = None, z: torch.Tensor | None = None,
               params: Mapping[str, torch.Tensor] | None = None) -> torch.Tensor:
        b = labels.shape[0]
        if z is None:
            z = torch.randn((b, grid, grid, channels), generator=generator,
                            device=labels.device)
        dt = 1.0 / num_steps
        use_cfg = cfg_scale != 1.0
        null = torch.full_like(labels, num_classes)
        for i in range(num_steps):
            # float32(1) - float32(i) * float32(dt), as the JAX loop computes t.
            t = 1.0 - torch.full((b,), float(i), device=z.device) * dt
            if use_cfg:
                v_c, v_u = _apply(model, params, torch.cat([z, z]), torch.cat([t, t]),
                                  torch.cat([labels, null])).chunk(2)
                v = v_u + cfg_scale * (v_c - v_u)
            else:
                v = _apply(model, params, z, t, labels)
            z = z - dt * v  # dz/dt = v points from data to noise: integrate down
        return z

    return sample


def _decode(vae_model, z: torch.Tensor) -> torch.Tensor:
    """Tokenizer-scale latents [B, h, w, C] -> images NHWC [0, 1] fp32."""
    with torch.no_grad():
        logits = vae_model.decode(z.permute(0, 3, 1, 2))
    return torch.sigmoid(logits.float()).permute(0, 2, 3, 1)


def generate_images(vae_model, vae_params: Any, dit_model, dit_params, stats: LatentStats,
                    generator: torch.Generator | None, labels: torch.Tensor, grid: int = 16,
                    num_steps: int = 50, cfg_scale: float = 1.0,
                    z: torch.Tensor | None = None) -> torch.Tensor:
    """Class-conditional generation: DiT sample -> denormalize -> TransVAE
    decode -> sigmoid: [B, H, W, 3] fp32 images in [0, 1] on the model's
    device. ``vae_params`` as ``evaluation.load_params`` takes them."""
    vae_model = load_params(vae_model, vae_params)
    sampler = make_sampler(dit_model, num_steps, cfg_scale, dit_model.config.num_classes)
    z = sampler(labels, grid, dit_model.config.in_channels, generator, z, dit_params)
    return _decode(vae_model, stats.denormalize(z))


def generation_fid(vae_model, vae_params: Any, dit_model, dit_params, stats: LatentStats,
                   real_batches: Iterable, feature_fn: Callable,
                   generator: torch.Generator | None, num_samples: int = 10_000,
                   batch_size: int = 64, grid: int = 16, num_steps: int = 50,
                   cfg_scale: float = 1.0, unconditional: bool = False) -> float:
    """Generation FID (the paper's FID-10K, Table 2b): ``num_samples``
    images through DiT -> TransVAE decode against ``real_batches`` (NHWC [0,
    1]), both under ``feature_fn`` (NCHW [0, 1] tensors on the model's
    device -> [B, F]: ``evaluation.make_fid_feature_fn``'s). Labels are
    drawn from ``generator`` (the null class for an ``unconditional``
    model, which never saw another), then the initial noise."""
    from ..utils.fid import fid_from_features

    vae_model = load_params(vae_model, vae_params)
    device = next(dit_model.parameters()).device
    num_classes = dit_model.config.num_classes
    sampler = make_sampler(dit_model, num_steps, cfg_scale, num_classes)

    def feats(images_nhwc: torch.Tensor) -> np.ndarray:
        return np.asarray(feature_fn(images_nhwc.permute(0, 3, 1, 2)).float().cpu(),
                          np.float64)

    fake, done = [], 0
    while done < num_samples:
        b = min(batch_size, num_samples - done)
        if unconditional:
            labels = torch.full((b,), num_classes, dtype=torch.long, device=device)
        else:
            labels = torch.randint(0, num_classes, (b,), generator=generator, device=device)
        z = sampler(labels, grid, dit_model.config.in_channels, generator, None, dit_params)
        fake.append(feats(_decode(vae_model, stats.denormalize(z))))
        done += b

    real, seen = [], 0
    for batch in real_batches:
        x = _nchw(batch, device).permute(0, 2, 3, 1)
        real.append(feats(x))
        seen += x.shape[0]
        if seen >= num_samples:
            break
    # Both sides trimmed to num_samples (FID-10K compares equal-sized sets).
    return fid_from_features(np.concatenate(real)[:num_samples],
                             np.concatenate(fake)[:num_samples])


def encode_to_latents(vae_model, vae_params: Any, images, sample: bool = False,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Images NHWC [0, 1] -> latents [B, h, w, D] in the model's dtype: mu
    (the paper's use of the tokenizer for generation), or with ``sample`` mu
    + eps exp(logvar / 2), eps drawn from ``generator``."""
    vae_model = load_params(vae_model, vae_params)
    x = _nchw(images, next(vae_model.parameters()).device)
    with torch.no_grad():
        mu, logvar = vae_model.encode(x.to(vae_model.config.compute_dtype))
    mu, logvar = mu.permute(0, 2, 3, 1), logvar.permute(0, 2, 3, 1)
    if sample:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        return mu + eps * torch.exp(0.5 * logvar)
    return mu
