"""Linear and Conv2d with the JAX package's dtype/param_dtype split, and the
initializers of its modules.

Parameters stay in their own dtype (float32 by default) and are cast to the
compute dtype of the input at each call, as flax's ``dtype``/``param_dtype``
do; the cast is free when the two agree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class GELU(nn.Module):
    """GELU at the compute precision: the tanh form in bf16 (within bf16's
    own rounding of the erf form), exact erf otherwise -- the JAX package's
    ``_gelu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


@torch.no_grad()
def init_linear_(m: nn.Linear, generator: torch.Generator | None) -> None:
    """truncated_normal(0.02) (cut at two standard deviations), zero bias."""
    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_conv_(m: nn.Conv2d, generator: torch.Generator | None) -> None:
    """Kaiming normal over fan_out (variance_scaling(2, 'fan_out', 'normal')),
    zero bias."""
    w = m.weight
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_out), generator=generator)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_small_conv_(m: nn.Conv2d, generator: torch.Generator | None,
                     scale: float = 1e-4) -> None:
    """variance_scaling(scale, 'fan_in', 'truncated_normal'), zero bias: the
    latent heads' small-variance init."""
    w = m.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    if m.bias is not None:
        m.bias.zero_()
