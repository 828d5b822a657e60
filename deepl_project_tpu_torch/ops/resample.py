"""Down/Upsample with DC (direct-connect) paths (PyTorch port of
``ops/resample.py``), on NCHW maps.

- Downsample: conv3x3 -> SiLU -> conv3x3 stride 2, plus the DC path
  pixel_unshuffle(2) -> 1x1 conv, summed.
- Upsample: nearest x2 -> conv3x3 -> SiLU -> conv3x3, plus the DC path
  1x1 conv to 4*C_out -> pixel_shuffle(2), summed.

By default each module runs the JAX package's exact fused forms (its
``fuse_dc`` and ``fuse_main`` flags, on by default there too):

- down DC: pixel_unshuffle + 1x1 conv is one 2x2 stride-2 conv, the 1x1
  weight [Co, 4C] read as [Co, C, 2, 2] (unshuffle's channel order
  c*4 + i*2 + j);
- up main: nearest x2 + conv3x3 is one stride-2 transposed conv with the
  4x4 kernel K[u, v] = sum over dy in S_u, dx in S_v of W[dy, dx],
  S = {0}, {0,1}, {1,2}, {2} (nearest duplication merges adjacent taps),
  summed in the compute dtype in the JAX module's order: 16 instead of 36
  multiply-adds an output and no 4x-size intermediate. JAX's lhs-dilated
  conv with padding 2 is a transposed conv with padding 1 and the kernel
  flipped;
- up DC: 1x1 conv to 4*Co + pixel_shuffle is one 2x2 stride-2 transposed
  conv, with the per-phase bias added to each (row, column) phase.

With a flag off the literal op order runs (torch's pixel_(un)shuffle, whose
channel order JAX's space_to_depth/depth_to_space reproduce).

Under an ambient context group (``parallel.context``: each rank holds its
rows of the map, split by ``row_split`` on the map's own height) the 3x3
and stride-2 convs fetch the rows their outputs read
(``ops.layers.Conv2d``, ``parallel.halo``): the fused down DC conv as a
2x2 stride-2 conv, the literal one by fetching the row pairs before
pixel_unshuffle. The up paths make global rows [2 lo, 2 hi) of the doubled
map from a rank's [lo, hi) (the fused up-conv reads one input row of halo a
side: transposed-conv padding 3 along H, output rows 3 .. 2h + 2 of the
padded input's, the crop) and move them onto the doubled height's split
(``halo.resplit_rows``: a no-op where 2 lo .. 2 hi is that split). The
module tree (main_path.{0,2} / main_path.{1,3}, dc_conv) and its parameters
are the reference's either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import context as cp
from ..parallel.collectives import fetch_rows
from ..parallel.halo import conv2d_rows, exchange_rows, on_rows, resplit_rows
from .layers import CachedOperands, Conv2d

# Taps of the 3x3 kernel that each of the fused up-conv's 4 rows (columns) sums.
_UP_TAPS = ((0,), (0, 1), (1, 2), (2,))


class Downsample(nn.Module):
    """Conv downsample x2 with an information-preserving DC shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_dc_path: bool = True, *, fuse_dc: bool = True, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.fuse_dc = fuse_dc
        self.main_path = nn.Sequential(
            Conv2d(in_channels, in_channels, 3, padding=1, **kw), nn.SiLU(),
            Conv2d(in_channels, out_channels, 3, stride=2, padding=1, **kw))
        self.dc_conv = (Conv2d(4 * in_channels, out_channels, 1, **kw)
                        if use_dc_path else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.main_path(x)
        if self.dc_conv is None:
            return y
        state = cp.current()
        if self.fuse_dc:
            w, b = self.dc_conv.weight, self.dc_conv.bias
            w = w.to(x.dtype).reshape(w.shape[0], w.shape[1] // 4, 2, 2)
            if state is not None:
                return y + conv2d_rows(x, w, b.to(x.dtype), 2, (0, 0), 1, state)
            return y + F.conv2d(x, w, b.to(x.dtype), stride=2)
        if state is not None:
            # The output's rows pair global rows 2o, 2o + 1 of the input.
            rows = state.map_rows(x)
            need = [(2 * o0, 2 * o1) for o0, o1 in state.split(rows // 2)]
            x = fetch_rows(x, state.split(rows), need, state.group)
            # (pixel_unshuffle's backward refuses a map of no rows.)
            return y + on_rows(lambda t: self.dc_conv(F.pixel_unshuffle(t, 2)), x, 2)
        return y + self.dc_conv(F.pixel_unshuffle(x, 2))


class Upsample(CachedOperands, nn.Module):
    """Conv upsample x2 with an information-preserving DC shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_dc_path: bool = True, *, fuse_main: bool = True,
                 fuse_dc: bool = True, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.fuse_main, self.fuse_dc = fuse_main, fuse_dc
        self.main_path = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv2d(in_channels, out_channels, 3, padding=1, **kw), nn.SiLU(),
            Conv2d(out_channels, out_channels, 3, padding=1, **kw))
        self.dc_conv = (Conv2d(in_channels, 4 * out_channels, 1, **kw)
                        if use_dc_path else None)

    def _up_kernel(self, dt: torch.dtype) -> torch.Tensor:
        """The fused up-conv's transposed-conv weight [Ci, Co, 4, 4] in
        ``dt``, cached per weight version; recomputed under autograd."""
        weight = self.main_path[1].weight

        def make():
            w = weight.to(dt)  # [Co, Ci, 3, 3]
            rows = []
            for su in _UP_TAPS:
                cols = []
                for sv in _UP_TAPS:
                    acc = None
                    for dy in su:
                        for dx in sv:
                            acc = w[:, :, dy, dx] if acc is None else acc + w[:, :, dy, dx]
                    cols.append(acc)
                rows.append(torch.stack(cols, -1))
            k4 = torch.stack(rows, -2)  # [Co, Ci, u, v]
            return k4.flip(2, 3).transpose(0, 1).contiguous()

        return self._cached(("up", dt), (weight,), make, differentiable=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        state = cp.current()
        if state is not None:
            return self._context_forward(x, state)
        if self.fuse_main:
            conv = self.main_path[1]
            y = F.conv_transpose2d(x, self._up_kernel(x.dtype), conv.bias.to(x.dtype),
                                   stride=2, padding=1)
            y = self.main_path[3](F.silu(y))
        else:
            y = self.main_path(x)
        if self.dc_conv is None:
            return y
        return y + self._dc(x)

    def _dc(self, x: torch.Tensor) -> torch.Tensor:
        """The DC path on rows ``x``: 2x their rows (row-local)."""
        if not self.fuse_dc:
            # (pixel_shuffle's backward refuses a map of no rows.)
            return on_rows(lambda t: F.pixel_shuffle(self.dc_conv(t), 2), x, 1)
        w, b = self.dc_conv.weight, self.dc_conv.bias  # [4 Co, Ci, 1, 1], [4 Co]
        co = w.shape[0] // 4
        k = w.to(x.dtype).reshape(co, 2, 2, w.shape[1]).permute(3, 0, 1, 2)
        dc = on_rows(lambda t: F.conv_transpose2d(t, k, stride=2), x, 1)
        dc = dc.permute(0, 2, 3, 1)  # [B, 2H, 2W, Co]
        bsz, h2, w2, _ = dc.shape
        btile = b.to(x.dtype).reshape(co, 2, 2).permute(1, 2, 0)  # [i, j, Co]
        dc = dc.reshape(bsz, h2 // 2, 2, w2 // 2, 2, co) + btile[:, None]
        return dc.reshape(bsz, h2, w2, co).permute(0, 3, 1, 2)

    def _context_forward(self, x: torch.Tensor, state) -> torch.Tensor:
        """This rank's rows of the output: the up-conv (fused: this rank's
        rows and one halo row a side, transposed-conv padding 3 along H, so
        output rows 3 .. 2h + 2 of the padded input's; literal: the nearest
        upsample) gives global rows [2 lo, 2 hi), which move onto the split
        of the output's height before the next 3x3 conv reads them; the DC
        path's likewise."""
        rows = state.map_rows(x)
        doubled = [(2 * lo, 2 * hi) for lo, hi in state.split(rows)]
        if self.fuse_main:
            conv = self.main_path[1]
            xp = exchange_rows(x, 1, 1, state.group, rows)
            k, bias = self._up_kernel(x.dtype), conv.bias.to(x.dtype)
            up = lambda t: F.conv_transpose2d(t, k, bias, stride=2, padding=(3, 1))  # noqa: E731
            y = up(xp) if x.shape[2] else up(F.pad(xp, (0, 0, 0, 1)))[:, :, :0]
            y = resplit_rows(y, state, doubled, 2 * rows)
            y = self.main_path[3](F.silu(y))
        else:
            y = on_rows(self.main_path[0], x, 1)
            y = self.main_path[1:](resplit_rows(y, state, doubled, 2 * rows))
        if self.dc_conv is None:
            return y
        return y + resplit_rows(self._dc(x), state, doubled, 2 * rows)
