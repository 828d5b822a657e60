"""Normalization layers with fp32 statistics (PyTorch port of ``ops/norms.py``).

All statistics are computed in float32 whatever the compute dtype, then the
result is cast back to the input's dtype. Feature maps are NCHW (any memory
format); LayerNorm works on token tensors ``[..., C]``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class RMSNorm(nn.Module):
    """Root-mean-square norm over the channel axis of an NCHW map:
    rms = sqrt(mean(x^2) + eps), eps *inside* the sqrt like the reference."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        rms = torch.sqrt(x32.square().mean(dim=1, keepdim=True) + self.eps)
        y = (x32 / rms) * self.weight.float()[:, None, None]
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with weight+bias, fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def gn_groups(dim: int, target: int = 32) -> int:
    """Largest group count <= target dividing dim (32 for every real variant)."""
    return math.gcd(dim, target) if dim % target else target


class GroupNorm(nn.Module):
    """GroupNorm over an NCHW map, channels grouped contiguously.

    Statistics per (batch, group) over all spatial positions, fp32, from
    single-pass moments var = max(E[x^2] - E[x]^2, 0) as the JAX module
    computes them.
    """

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-5, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        assert dim % num_groups == 0, (dim, num_groups)
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        # [B, H*W, G, C/G]: a view for channels_last input.
        x32 = x.permute(0, 2, 3, 1).reshape(b, h * w, g, c // g).float()
        m1 = x32.mean(dim=(1, 3), keepdim=True)
        m2 = x32.square().mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(m2 - m1.square(), min=0.0)
        y = ((x32 - m1) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype).permute(0, 3, 1, 2)
