"""Feed-forward networks (PyTorch port of ``ops/ffn.py``): the convolutional
FFN and a standard MLP, on NCHW maps.

ConvFFN expands the channels by mlp_ratio*4 with a Linear, GELU, runs a conv
branch *with residual* at the expanded width, then projects back.
conv_type='full' is 1x1 -> GELU -> 3x3 -> GELU -> 1x1 at mlp_ratio*dim width;
'depthwise' is one 3x3 depthwise conv.

The port runs the literal op order. The JAX module's default
``fold_output`` reassociation ((y + z W2) Wout = y Wout + z (W2 Wout)) is the
same math with other rounding, and is left to a later change; the parameter
names are the reference's either way.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import GELU, Conv2d, Linear


class ConvFFN(nn.Module):
    """Inverted-bottleneck FFN with spatial conv mixing."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, conv_type: str = "full",
                 *, device=None, param_dtype=torch.float32):
        super().__init__()
        hidden = int(dim * mlp_ratio * 4)
        kw = dict(device=device, dtype=param_dtype)
        self.proj_in = Linear(dim, hidden, **kw)
        if conv_type == "full":
            ch = int(dim * mlp_ratio)
            self.conv = nn.Sequential(
                Conv2d(hidden, ch, 1, **kw), GELU(),
                Conv2d(ch, ch, 3, padding=1, **kw), GELU(),
                Conv2d(ch, hidden, 1, **kw))
        elif conv_type == "depthwise":
            self.conv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden, **kw)
        else:
            raise ValueError(f"Unknown conv_type: {conv_type}")
        self.act = GELU()
        self.proj_out = Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.proj_in(x.permute(0, 2, 3, 1)))  # [B, H, W, hidden]
        y = y.permute(0, 3, 1, 2)  # NCHW view, channels-last in memory
        y = y + self.conv(y)  # residual around the conv branch
        return self.proj_out(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class StandardFFN(nn.Module):
    """Plain Linear-GELU-Linear FFN (ablation baseline)."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, *, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        kw = dict(device=device, dtype=param_dtype)
        self.fc1 = Linear(dim, hidden, **kw)
        self.act = GELU()
        self.fc2 = Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc2(self.act(self.fc1(x.permute(0, 2, 3, 1))))
        return y.permute(0, 3, 1, 2)
