"""Down/Upsample with DC (direct-connect) paths (PyTorch port of
``ops/resample.py``), on NCHW maps.

- Downsample: conv3x3 -> SiLU -> conv3x3 stride 2, plus the DC path
  pixel_unshuffle(2) -> 1x1 conv, summed.
- Upsample: nearest x2 -> conv3x3 -> SiLU -> conv3x3, plus the DC path
  1x1 conv to 4*C_out -> pixel_shuffle(2), summed.

The port runs this literal op order with torch's pixel_(un)shuffle, whose
channel order is the one the JAX package's space_to_depth/depth_to_space
reproduce. The JAX package's fused rewrites (one 2x2 stride-2 conv for the
down DC path, one transposed conv for nearest+conv3x3 and for the up DC
path) are the same math with other rounding and fewer FLOPs, left to a later
change. The module tree (main_path.{0,2} / main_path.{1,3}, dc_conv) is the
reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class Downsample(nn.Module):
    """Conv downsample x2 with an information-preserving DC shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_dc_path: bool = True, *, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.main_path = nn.Sequential(
            Conv2d(in_channels, in_channels, 3, padding=1, **kw), nn.SiLU(),
            Conv2d(in_channels, out_channels, 3, stride=2, padding=1, **kw))
        self.dc_conv = (Conv2d(4 * in_channels, out_channels, 1, **kw)
                        if use_dc_path else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.main_path(x)
        if self.dc_conv is not None:
            y = y + self.dc_conv(F.pixel_unshuffle(x, 2))
        return y


class Upsample(nn.Module):
    """Conv upsample x2 with an information-preserving DC shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_dc_path: bool = True, *, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.main_path = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv2d(in_channels, out_channels, 3, padding=1, **kw), nn.SiLU(),
            Conv2d(out_channels, out_channels, 3, padding=1, **kw))
        self.dc_conv = (Conv2d(in_channels, 4 * out_channels, 1, **kw)
                        if use_dc_path else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.main_path(x)
        if self.dc_conv is not None:
            y = y + F.pixel_shuffle(self.dc_conv(x), 2)
        return y
