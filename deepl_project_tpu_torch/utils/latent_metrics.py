"""Latent-space diagnostics (PyTorch port of ``utils/latent_metrics.py``):
the paper's Table 2(b) distribution metrics (density CV, normalized
entropy, Gini of the latent-value histogram) and its Table 2(a) linear
probe on spatially pooled latents.

The histogram metrics are the JAX package's numpy code. The probe trains a
zero-initialised linear layer with ``torch.optim.Adam`` (the update of
optax's ``adam`` at its defaults) on the features' device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F


def latent_histogram(latents: np.ndarray, bins: int = 256,
                     value_range: tuple = (-5.0, 5.0)) -> np.ndarray:
    """Normalized histogram of latent values (all dims pooled)."""
    hist, _ = np.histogram(np.asarray(latents).ravel(), bins=bins, range=value_range)
    p = hist.astype(np.float64)
    return p / max(p.sum(), 1)


def density_cv(latents: np.ndarray, bins: int = 256) -> float:
    """Coefficient of variation of occupied histogram mass: 0 for a uniform
    occupancy, larger = peakier/clumpier latent density."""
    p = latent_histogram(latents, bins)
    occupied = p[p > 0]
    return float(occupied.std() / max(occupied.mean(), 1e-12))


def normalized_entropy(latents: np.ndarray, bins: int = 256) -> float:
    """Shannon entropy of the value histogram / log(bins), in [0, 1]."""
    p = latent_histogram(latents, bins)
    nz = p[p > 0]
    return float(-(nz * np.log(nz)).sum() / np.log(bins))


def gini(latents: np.ndarray, bins: int = 256) -> float:
    """Gini coefficient of histogram mass, in [0, 1]; 0 = perfectly uniform."""
    p = np.sort(latent_histogram(latents, bins))
    n = len(p)
    cum = np.cumsum(p)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def latent_diagnostics(latents: np.ndarray, bins: int = 256) -> dict:
    return {"density_cv": density_cv(latents, bins),
            "normalized_entropy": normalized_entropy(latents, bins),
            "gini": gini(latents, bins)}


def linear_probe(features, labels, num_classes: int, steps: int = 500, lr: float = 1e-2,
                 val_fraction: float = 0.2, seed: int = 0, device=None) -> dict:
    """Train a linear classifier on [N, D] features (numpy or a tensor) with
    full-batch Adam; returns train/val accuracy and the last step's loss.
    The split is the JAX function's (numpy ``default_rng(seed)``
    permutation, the first ``val_fraction`` held out). ``device`` defaults
    to the features' (CPU for numpy)."""
    features = torch.as_tensor(features)
    device = torch.device(device) if device is not None else features.device
    x = features.to(device, torch.float32)
    y = torch.as_tensor(np.asarray(labels)).to(device, torch.long)
    rng = np.random.default_rng(seed)
    n = len(x)
    order = torch.as_tensor(rng.permutation(n), device=device)
    n_val = max(1, int(n * val_fraction))
    val_idx, train_idx = order[:n_val], order[n_val:]
    xtr, ytr, xva, yva = x[train_idx], y[train_idx], x[val_idx], y[val_idx]

    w = torch.zeros(x.shape[1], num_classes, device=device, requires_grad=True)
    b = torch.zeros(num_classes, device=device, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(xtr @ w + b, ytr)
        loss.backward()
        opt.step()

    with torch.no_grad():
        def acc(xs, ys):
            return float(((xs @ w + b).argmax(dim=-1) == ys).float().mean())

        return {"train_acc": acc(xtr, ytr), "val_acc": acc(xva, yva),
                "final_loss": float(loss)}


@torch.no_grad()
def pool_latents(model, params, batches: Iterator) -> np.ndarray:
    """Spatially mean-pooled mu latents for probing: [N, latent_dim] from
    NHWC [0, 1] batches, encoded on the model's device. ``params`` is as in
    ``evaluation``: None, a state_dict or a checkpoint state."""
    from ..evaluation import _device, _nchw, load_params

    model = load_params(model, params).eval()
    device = _device(model)
    feats = []
    for batch in batches:
        mu, _ = model.encode(_nchw(batch, device).to(model.config.compute_dtype))
        feats.append(mu.float().mean(dim=(2, 3)).cpu().numpy())
    return np.concatenate(feats)
