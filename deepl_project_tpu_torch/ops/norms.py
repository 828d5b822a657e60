"""Normalization layers with fp32 statistics (PyTorch port of ``ops/norms.py``).

All statistics are computed in float32 whatever the compute dtype, then the
result is cast back to the input's dtype. Feature maps are NCHW (any memory
format); LayerNorm works on token tensors ``[..., C]``.
:func:`group_norm_silu` is the model's GroupNorm -> SiLU site.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import context as cp
from ..parallel.collectives import sum_over_group
from .hopper import fused_norm


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
    computes them. Under an ambient context group (each rank holds its rows
    of the map) the sums of x and x^2 are summed over the group, one fp32
    all-reduce of [B, G, 2] (``collectives.sum_over_group``: its backward
    sums every rank's gradient), and divided by the global map's count
    (``ContextState.map_rows``: the ranks' shares may differ, or be none).
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
        state = cp.current()
        if state is None:
            m1 = x32.mean(dim=(1, 3), keepdim=True)
            m2 = x32.square().mean(dim=(1, 3), keepdim=True)
        else:
            sums = torch.stack([x32.sum(dim=(1, 3)), x32.square().sum(dim=(1, 3))], -1)
            count = state.map_rows(x) * w * (c // g)
            moments = sum_over_group(sums, state.group) / count
            m1, m2 = (moments[..., i].reshape(b, 1, g, 1) for i in range(2))
        var = torch.clamp(m2 - m1.square(), min=0.0)
        y = ((x32 - m1) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype).permute(0, 3, 1, 2)


# The model's one switch for the fused GroupNorm -> SiLU kernels: a port
# dispatch choice, on by default (the in-model A/B on the card); flipped only
# by chip_smoke.py and the tests.
FUSE_NORM_SILU = True


def group_norm_silu(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """silu(norm(x)). With :data:`FUSE_NORM_SILU` on and ``x`` a no-grad
    CUDA bf16 map (``fused_norm.group_norm_silu_supported``), the fused
    kernel pair, which rounds once to x's dtype after SiLU and raises on a
    map that is not channels_last; otherwise the two modules as the JAX
    model runs them, rounding after the norm and again after SiLU. Under an
    ambient context group the two modules run (the statistics' all-reduce
    falls between the kernel pair's launches; not fused yet)."""
    if (FUSE_NORM_SILU and cp.context_axis_size() == 1
            and fused_norm.group_norm_silu_supported(x, norm.weight, norm.bias)):
        return fused_norm.group_norm_silu(x, norm.weight, norm.bias, norm.num_groups,
                                          norm.eps)
    return F.silu(norm(x))
