"""Reconstruction metrics (PyTorch port of ``utils/metrics.py``), per image
on NCHW batches in [0, max_val]: PSNR, and SSIM with the 11x11 Gaussian
window (sigma 1.5, valid windows, C1/C2 of Wang et al.); ``summarize`` for
the per-image vectors."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """[B, C, H, W] x2 -> [B] dB."""
    mse = (x.float() - y.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """[B, C, H, W] x2 -> [B]: mean SSIM over channels and windows, with the
    variance estimates clamped at 0 as in the JAX version."""
    x, y = x.float(), y.float()
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    ch = x.shape[1]
    kern = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(x.device)
    k4 = kern.expand(ch, 1, window_size, window_size)

    def filt(img):
        return F.conv2d(img, k4, groups=ch)

    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = torch.clamp(filt(x * x) - mu_x2, min=0.0)
    sigma_y = torch.clamp(filt(y * y) - mu_y2, min=0.0)
    sigma_xy = filt(x * y) - mu_xy
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def summarize(values) -> dict:
    """mean/std/median/min/max of per-image values, as the reference reports
    them (evaluate.py:136-143); numpy arrays or tensors."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    v = np.asarray(values, np.float64)
    return {"mean": float(v.mean()), "std": float(v.std()),
            "median": float(np.median(v)), "min": float(v.min()),
            "max": float(v.max())}
