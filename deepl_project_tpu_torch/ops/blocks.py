"""Building blocks (PyTorch port of ``ops/blocks.py``): the CNN ResBlock and
the hybrid TransVAE block, on NCHW maps."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import AttentionRoPE
from .ffn import ConvFFN, StandardFFN
from .layers import Conv2d
from .norms import GroupNorm, RMSNorm, gn_groups
from .quant import QConv2d, record_amax


class ResBlock(nn.Module):
    """GroupNorm(32) -> SiLU -> 3x3 conv, twice, plus a 1x1 (or 3x3)
    shortcut when the channel count changes.

    ``quant='int8'``: the three convs are int8 (``QConv2d``), the norms and
    SiLU stay float. ``calibrate``: record the absmax of each conv's input
    (sites ``amax_h1``, ``amax_h2``, ``amax_x``) in ``self.amax``."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_conv_shortcut: bool = False, *, quant: str | None = None,
                 calibrate: bool = False, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)

        def conv(cin, cout, k):
            if quant == "int8":
                return QConv2d(cin, cout, k, device=device)
            return Conv2d(cin, cout, k, padding=k // 2, **kw)

        self.calibrate, self.amax = calibrate, {}
        self.norm1 = GroupNorm(gn_groups(in_channels), in_channels, **kw)
        self.conv1 = conv(in_channels, out_channels, 3)
        self.norm2 = GroupNorm(gn_groups(out_channels), out_channels, **kw)
        self.conv2 = conv(out_channels, out_channels, 3)
        self.shortcut = None
        if in_channels != out_channels:
            self.shortcut = conv(in_channels, out_channels, 3 if use_conv_shortcut else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.norm1(x))
        if self.calibrate:
            record_amax(self, "amax_h1", h)
        h = F.silu(self.norm2(self.conv1(h)))
        if self.calibrate:
            record_amax(self, "amax_h2", h)
        h = self.conv2(h)
        if self.shortcut is None:
            return h + x
        if self.calibrate:
            record_amax(self, "amax_x", x)
        return h + self.shortcut(x)


class TransVAEBlock(nn.Module):
    """Pre-norm transformer block on feature maps:
    x + attn(RMSNorm(x)); x + ffn(RMSNorm(x))."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, head_dim: int = 64,
                 use_rope: bool = True, rope_pairing: str = "reference",
                 use_conv_ffn: bool = True, conv_ffn_type: str = "full",
                 attention_impl: str = "auto", *, quant: str | None = None,
                 calibrate: bool = False, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        self.norm1 = RMSNorm(dim, device=device, dtype=param_dtype)
        self.attn = AttentionRoPE(dim, head_dim, use_rope, rope_pairing,
                                  attention_impl, **kw)
        self.norm2 = RMSNorm(dim, device=device, dtype=param_dtype)
        # quant and calibrate reach the ConvFFN only: attention stays bf16.
        self.ffn = (ConvFFN(dim, mlp_ratio, conv_ffn_type, quant=quant,
                            calibrate=calibrate, **kw) if use_conv_ffn
                    else StandardFFN(dim, mlp_ratio, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))
