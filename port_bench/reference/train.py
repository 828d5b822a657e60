"""Plain stage-1 training steps in float32: the loss, the gradients and
AdamW with global-norm clipping, computed in blocks of images.

The loss is the reference recipe's stage 1 (``configs/transvae_large_f16d32
.yaml``): L1 on sigmoid(logits) against the [0, 1] target, LPIPS on the
images mapped to [-1, 1], and KL(q(z|x) || N(0, 1)) with logvar clamped,
each a mean over the batch, weighted and summed; the decoder reads the
posterior sample mu + eps * exp(logvar / 2), with ``eps`` handed in. A
step's batch of B images in M microbatches has the gradient of the mean
over all B images (each microbatch's mean, averaged), which is what is
computed here, ``block`` images at a time, so that float32 activations fit.

AdamW is optax's: the gradient clipped to ``max_grad_norm`` when its global
norm reaches it, mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
bias-corrected with the step count, p -= lr (mu_hat / (sqrt(nu_hat) + eps)
+ wd p), lr rising linearly from 0 over ``warmup_steps`` (read at the
0-based count of updates). A step with a non-finite gradient would be skipped; the benchmark
treats one as a failed comparison instead.

The convolutions of the gradient pass run on PyTorch's own kernels (im2col
and cuBLAS SGEMM), not cuDNN's: in float32 without TF32, cuDNN picked FFT
algorithms for the backward that took ~4-6 s a block of two images on an
H100, ten times the products' work at SGEMM rates.
"""

from __future__ import annotations

import torch

from . import lpips as lpips_ref
from . import model as ref


def block_loss(cfg, params, lp, target, eps, weights, ops):
    """Per-image loss terms of a block: dict of [b] tensors (l1, lpips,
    kl) and the weighted per-image total. ``target`` NCHW in [0, 1]."""
    logits, mu, logvar = ref.forward(cfg, params, target, eps=eps, ops=ops)
    recon = torch.sigmoid(logits)
    terms = {"l1": (recon - target).abs().mean(dim=(1, 2, 3))}
    terms["lpips"] = lpips_ref.distance(lp, (recon * 2 - 1).clamp(-1, 1),
                                        (target * 2 - 1).clamp(-1, 1), ops)
    lv = logvar.clamp(*cfg["logvar_clip"])
    terms["kl"] = (-0.5 * (1.0 + lv - mu.square() - lv.exp())).mean(dim=(1, 2, 3))
    terms["total"] = sum(weights[k] * terms[k] for k in ("l1", "lpips", "kl"))
    return terms


def gradients(cfg, params: dict, lp: dict, batch: torch.Tensor, eps: list, weights: dict,
              micro: int, block: int, ops=None):
    """(grads, loss terms) of one step: ``batch`` [B, H, W, 3] in [0, 1],
    ``eps`` one noise tensor per microbatch of ``micro`` images. Gradients
    (a dict like ``params``) of the mean loss over the B images."""
    ops = ops or ref.Ops()
    for t in params.values():
        t.grad = None
    n = batch.shape[0]
    sums = {}
    with torch.backends.cudnn.flags(enabled=False):
        _accumulate(cfg, params, lp, batch, eps, weights, micro, block, ops, sums)
    grads = {k: t.grad for k, t in params.items()}
    for t in params.values():
        t.grad = None
    return grads, {k: v / n for k, v in sums.items()}


def _accumulate(cfg, params, lp, batch, eps, weights, micro, block, ops, sums):
    n = batch.shape[0]
    for m in range(n // micro):
        for i in range(0, micro, block):
            rows = slice(m * micro + i, m * micro + i + block)
            target = batch[rows].permute(0, 3, 1, 2).float()
            terms = block_loss(cfg, params, lp, target, eps[m][i:i + block], weights, ops)
            (terms["total"].sum() / n).backward()
            for k, v in terms.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach().sum())


class AdamW:
    def __init__(self, params: dict, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float, warmup_steps: int = 0):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.warmup = warmup_steps
        self.eps, self.wd, self.max_norm = eps, weight_decay, max_grad_norm
        self.mu = {k: torch.zeros_like(t) for k, t in params.items()}
        self.nu = {k: torch.zeros_like(t) for k, t in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Apply one update; returns the clipped gradients."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        if not torch.isfinite(norm):
            raise FloatingPointError("non-finite gradient in the reference step")
        scale = self.max_norm / float(norm) if float(norm) >= self.max_norm else 1.0
        # The recipe's linear warmup from 0, read at the 0-based count.
        lr = self.lr * min(self.count / self.warmup, 1.0) if self.warmup else self.lr
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            p.sub_(lr * upd)
        return clipped
