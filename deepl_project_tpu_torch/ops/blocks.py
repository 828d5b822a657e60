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


class ResBlock(nn.Module):
    """GroupNorm(32) -> SiLU -> 3x3 conv, twice, plus a 1x1 (or 3x3)
    shortcut when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_conv_shortcut: bool = False, *, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.norm1 = GroupNorm(gn_groups(in_channels), in_channels, **kw)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.norm2 = GroupNorm(gn_groups(out_channels), out_channels, **kw)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        self.shortcut = None
        if in_channels != out_channels:
            k = 3 if use_conv_shortcut else 1
            self.shortcut = Conv2d(in_channels, out_channels, k, padding=k // 2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (x if self.shortcut is None else self.shortcut(x))


class TransVAEBlock(nn.Module):
    """Pre-norm transformer block on feature maps:
    x + attn(RMSNorm(x)); x + ffn(RMSNorm(x))."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, head_dim: int = 64,
                 use_rope: bool = True, rope_pairing: str = "reference",
                 use_conv_ffn: bool = True, conv_ffn_type: str = "full",
                 attention_impl: str = "auto", *, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        self.norm1 = RMSNorm(dim, device=device, dtype=param_dtype)
        self.attn = AttentionRoPE(dim, head_dim, use_rope, rope_pairing,
                                  attention_impl, **kw)
        self.norm2 = RMSNorm(dim, device=device, dtype=param_dtype)
        self.ffn = (ConvFFN(dim, mlp_ratio, conv_ffn_type, **kw) if use_conv_ffn
                    else StandardFFN(dim, mlp_ratio, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))
