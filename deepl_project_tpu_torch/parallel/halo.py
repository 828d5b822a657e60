"""Row exchanges of row-sharded maps under context parallelism (no JAX
counterpart: there GSPMD halo-exchanges every convolution whose input is
sharded over the ``context`` axis, and pads the maps it splits unevenly).

Every map is split by ``context.row_split`` on its own global height, so a
rank may hold fewer rows than a halo, or none, and a stride-2 output row's
inputs need not start on a rank's first row. Each operation here takes the
global rows its outputs read with ``collectives.fetch_rows`` (from
whichever ranks hold them; zeros beyond the global map's edges, its zero
padding) and computes this rank's rows of the whole map's result:

- :func:`exchange_rows`: this rank's rows with ``top`` rows above and
  ``bottom`` below;
- :func:`conv2d_rows` / :func:`context_conv2d`: a convolution of any kernel
  height, stride and padding (its output rows by the split of the output's
  height, its inputs read from the global row parity);
- :func:`pool2x2_rows`: a 2x2 stride-2 max pool (floor at an odd height);
- :func:`resplit_rows`: a map whose ranks hold other rows than the split
  gives them (an upsample's 2 lo .. 2 hi) moved onto the split.

:func:`on_rows` runs a spatial operation on a rank that holds no rows (torch
refuses maps of zero rows): on zero rows appended, cut back to none, so the
graph and every collective of the backward stay the same on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .collectives import fetch_rows
from .context import row_split


def on_rows(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn(x)``; where ``x`` holds no rows, ``fn`` of ``rows`` zero rows cut
    to none (``rows``: enough for ``fn`` to make one)."""
    if x.shape[2]:
        return fn(x)
    pad = x.new_zeros(x.shape[:2] + (rows,) + x.shape[3:])
    return fn(torch.cat([x, pad], 2))[:, :, :0]


def _size(group) -> int:
    return dist.get_world_size(group)


def exchange_rows(x: torch.Tensor, top: int, bottom: int, group,
                  rows: int | None = None) -> torch.Tensor:
    """x [B, C, h, W] (this rank's rows of a map of ``rows`` global rows,
    split by ``row_split``; default h times the group's size, an even
    split) -> [B, C, top + h + bottom, W]: the ``top`` global rows above
    this rank's first and the ``bottom`` below its last, from whichever
    ranks hold them, zeros beyond the global map's edges. x's memory format
    is kept."""
    if top == 0 and bottom == 0:
        return x
    held = row_split(x.shape[2] * _size(group) if rows is None else rows, _size(group))
    return fetch_rows(x, held, [(lo - top, hi + bottom) for lo, hi in held], group)


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor, bias, stride: int, padding: tuple,
                groups: int, state, rows: int | None = None) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, groups=groups)`` of the
    whole map, on this rank's rows ``x`` under the context ``state``
    (``rows``: the map's global rows, default ``state.map_rows(x)``): this
    rank's rows of the output, split by the output's global height. Output
    row o reads input rows stride o - padding .. + kernel - 1, fetched from
    whichever ranks hold them; the convolution then runs with no padding
    along H and its own along W."""
    rows = state.map_rows(x) if rows is None else rows
    k, pad = weight.shape[2], padding[0]
    out = state.split((rows + 2 * pad - k) // stride + 1)
    need = [(o0 * stride - pad, (o1 - 1) * stride - pad + k) if o1 > o0
            else (o0 * stride - pad, o0 * stride - pad) for o0, o1 in out]
    xp = fetch_rows(x, state.split(rows), need, state.group)
    return on_rows(lambda t: F.conv2d(t, weight, bias, stride, (0, padding[1]), groups=groups),
                   xp, k)


def context_conv2d(conv, x: torch.Tensor, state) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d``: zero padding, no dilation, the same
    stride along both axes) on this rank's rows ``x`` under the context
    ``state``, with the weights cast to x's dtype: :func:`conv2d_rows`, or
    for a 1x1 kernel at stride 1 the convolution of the rows as they are."""
    if (conv.dilation != (1, 1) or conv.padding_mode != "zeros"
            or conv.stride[0] != conv.stride[1]):
        raise NotImplementedError(f"{conv} under context parallelism")
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    weight = conv.weight.to(x.dtype)
    if conv.kernel_size[0] == 1 and conv.stride[0] == 1 and conv.padding[0] == 0:
        return on_rows(lambda t: conv._conv_forward(t, weight, bias), x, 1)
    return conv2d_rows(x, weight, bias, conv.stride[0], conv.padding, conv.groups, state)


def pool2x2_rows(x: torch.Tensor, state, rows: int) -> torch.Tensor:
    """``F.max_pool2d(x, 2, 2)`` of the whole map of ``rows`` global rows on
    this rank's rows ``x``: output row o pairs global rows 2o and 2o + 1
    (an odd height's last row is dropped, as on one device), this rank's
    outputs split by the output's height."""
    out = state.split(rows // 2)
    xp = fetch_rows(x, state.split(rows), [(2 * o0, 2 * o1) for o0, o1 in out], state.group)
    return on_rows(lambda t: F.max_pool2d(t, 2, 2), xp, 2)


def resplit_rows(y: torch.Tensor, state, held: list[tuple[int, int]], rows: int
                 ) -> torch.Tensor:
    """A map of ``rows`` global rows whose rank c holds ``held[c]`` (``y``:
    this rank's), moved onto ``row_split``'s split; ``y`` itself where the
    two agree."""
    split = state.split(rows)
    if list(map(tuple, held)) == split:
        return y
    return fetch_rows(y, held, split, state.group)
