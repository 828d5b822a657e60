"""The training step: forward, loss, backward, update (PyTorch port of
``training/train_step.py``, stage 1).

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

The GAN step (stage 2) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..losses.vae_loss import LossWeights, transvae_loss
from .optim import AdamW


@dataclasses.dataclass
class TrainState:
    """What a step carries: the step count, the model (its parameters), the
    optimizer (its moments and counts) and, with EMA on, the shadow
    parameters by name."""

    step: int
    model: torch.nn.Module
    optimizer: AdamW
    ema: dict[str, torch.Tensor] | None = None


def init_ema(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def _ema_update(ema_decay: float, ema: dict, model: torch.nn.Module) -> None:
    """ema = decay * ema + (1 - decay) * params, in place."""
    names = list(ema)
    params = dict(model.named_parameters())
    shadow = [ema[n] for n in names]
    torch._foreach_mul_(shadow, ema_decay)
    torch._foreach_add_(shadow, [params[n].detach() for n in names],
                        alpha=1.0 - ema_decay)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The latent noise generator of one optimizer step."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def loss_and_metrics(model, images_nhwc: torch.Tensor, weights: LossWeights,
                     lpips_params: dict | None = None, sample: bool = True,
                     generator: torch.Generator | None = None):
    """(total loss, metrics) for one batch of [B, H, W, 3] images in [0, 1]:
    the model sees them in its compute dtype, the loss in fp32."""
    target = images_nhwc.permute(0, 3, 1, 2)
    x = target.to(model.config.compute_dtype)
    recon, mu, logvar = model(x, sample=sample, generator=generator)
    losses = transvae_loss(recon, target, mu, logvar, weights,
                           lpips_params=lpips_params)
    metrics = dict(losses)
    metrics["recon_finite_frac"] = torch.isfinite(recon).float().mean()
    metrics["mu_absmax"] = mu.detach().abs().max().float()
    return losses["total"], metrics


def compute_grads(model, batch: torch.Tensor, weights: LossWeights,
                  lpips_params: dict | None = None, accum_steps: int = 1,
                  sample: bool = True, generator: torch.Generator | None = None
                  ) -> tuple[list[torch.Tensor], dict]:
    """fp32 gradients (one per parameter, in ``named_parameters`` order)
    averaged over ``accum_steps`` microbatches of ``batch``, and the
    averaged metrics."""
    b = batch.shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
    params = list(model.parameters())
    for p in params:
        p.grad = None
    micro = b // accum_steps
    sums: dict[str, torch.Tensor] = {}
    for i in range(accum_steps):
        loss, metrics = loss_and_metrics(model, batch[i * micro:(i + 1) * micro],
                                         weights, lpips_params, sample, generator)
        loss.backward()
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach().float()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for p in params:
        p.grad = None
    if accum_steps > 1:
        torch._foreach_mul_(grads, 1.0 / accum_steps)
    return grads, {k: v / accum_steps for k, v in sums.items()}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(tensors)).norm()


def make_train_step(weights: LossWeights = LossWeights(),
                    lpips_params: dict | None = None, accum_steps: int = 1,
                    ema_decay: float | None = None, seed: int = 0,
                    sample: bool = True) -> Callable:
    """fn(state, batch) -> metrics: one optimizer step on ``batch``
    ([B, H, W, 3] in [0, 1] on the model's device), updating ``state`` in
    place. Metrics stay on the device (one host sync per step, the
    optimizer's finiteness check)."""

    def train_step(state: TrainState, batch: torch.Tensor) -> dict:
        model = state.model
        gen = step_generator(seed, state.step, batch.device)
        grads, metrics = compute_grads(model, batch, weights, lpips_params,
                                       accum_steps, sample, gen)
        metrics["grad_norm"] = global_norm(grads)
        state.optimizer.step(grads)
        if ema_decay is not None:
            _ema_update(ema_decay, state.ema, model)
        state.step += 1
        return metrics

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
