"""Halo exchange of row-sharded maps under context parallelism (no JAX
counterpart: there GSPMD halo-exchanges every convolution whose input is
sharded over the ``context`` axis).

:func:`exchange_rows` pads this rank's rows of an NCHW map with its
neighbours' edge rows (zeros above the first rank and below the last, the
global map's zero padding); its backward sends the halo rows' gradients
back and adds them into the neighbours' edge rows. :func:`context_conv2d`
runs a convolution on the padded rows with no padding along H, so each rank
computes exactly its rows of the whole map's convolution.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .collectives import send_recv


def _rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return x[:, :, lo:hi]


def _format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, group):
        ctx.top, ctx.bottom, ctx.group = top, bottom, group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        b, c, h, w = x.shape
        if h < max(top, bottom):
            raise ValueError(f"a halo of {max(top, bottom)} rows is deeper than this rank's "
                             f"{h} rows")
        fmt = _format(x)
        # This rank's last `top` rows are the next rank's upper halo; its
        # first `bottom` rows the previous rank's lower halo.
        above, below = (torch.empty((b, c, n, w), dtype=x.dtype, device=x.device,
                                    memory_format=fmt).zero_() for n in (top, bottom))
        sends, recvs = [], []
        if top and rank < size - 1:
            sends.append((_rows(x, h - top, h), rank + 1))
        if top and rank > 0:
            recvs.append((above, rank - 1))
        if bottom and rank > 0:
            sends.append((_rows(x, 0, bottom), rank - 1))
        if bottom and rank < size - 1:
            recvs.append((below, rank + 1))
        send_recv(sends, recvs, group)
        return torch.cat([above, x, below], 2).contiguous(memory_format=fmt)

    @staticmethod
    def backward(ctx, g):
        top, bottom, group = ctx.top, ctx.bottom, ctx.group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        h = g.shape[2] - top - bottom
        gx = _rows(g, top, top + h).clone()
        b, c, _, w = g.shape
        from_next = g.new_zeros(b, c, top, w)
        from_prev = g.new_zeros(b, c, bottom, w)
        sends, recvs = [], []
        # The upper halo's gradient belongs to the previous rank's last rows,
        # the lower halo's to the next rank's first rows.
        if top and rank > 0:
            sends.append((_rows(g, 0, top), rank - 1))
        if top and rank < size - 1:
            recvs.append((from_next, rank + 1))
        if bottom and rank < size - 1:
            sends.append((_rows(g, top + h, top + h + bottom), rank + 1))
        if bottom and rank > 0:
            recvs.append((from_prev, rank - 1))
        send_recv(sends, recvs, group)
        if top:
            gx[:, :, h - top:] += from_next
        if bottom:
            gx[:, :, :bottom] += from_prev
        return gx, None, None, None


def exchange_rows(x: torch.Tensor, top: int, bottom: int, group) -> torch.Tensor:
    """x [B, C, h, W] (this rank's rows) -> [B, C, top + h + bottom, W]: the
    previous rank's last ``top`` rows above, the next rank's first
    ``bottom`` rows below, zeros beyond the global map's edges. x's memory
    format is kept."""
    if top == 0 and bottom == 0:
        return x
    return _ExchangeRows.apply(x, top, bottom, group)


def conv_halo(kernel: int, stride: int, padding: int) -> tuple[int, int]:
    """(top, bottom) halo rows of a convolution along H on row-sharded input
    whose local row count and first row are multiples of ``stride``: output
    row o reads input rows stride o - padding .. + kernel - 1, so the
    first local output reads ``padding`` rows above and the last one
    kernel - stride - padding rows below."""
    bottom = kernel - stride - padding
    if bottom < 0 or padding < 0:
        raise ValueError(f"conv (kernel {kernel}, stride {stride}, padding {padding}) "
                         "has no row-local form under context parallelism")
    return padding, bottom


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor, bias, stride: int, padding: tuple,
                groups: int, state) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, groups=groups)`` of the
    whole map, on this rank's rows ``x`` under the context ``state``: the
    halo exchange, then the convolution with no padding along H and its own
    along W. The local row count and the first row must be multiples of the
    stride."""
    h = x.shape[2]
    if h % stride or (state.rank * h) % stride:
        raise ValueError(f"{h} rows a rank do not split at stride {stride}")
    top, bottom = conv_halo(weight.shape[2], stride, padding[0])
    xp = exchange_rows(x, top, bottom, state.group)
    return F.conv2d(xp, weight, bias, stride, (0, padding[1]), groups=groups)


def context_conv2d(conv, x: torch.Tensor, state) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d``: zero padding, no dilation, the same
    stride along both axes) on this rank's rows ``x`` under the context
    ``state``, with the weights cast to x's dtype. Stride 1 (halo
    kernel // 2 rows a side) and stride 2 with padding 1 (one row above)
    are the model's."""
    if (conv.dilation != (1, 1) or conv.padding_mode != "zeros"
            or conv.stride[0] != conv.stride[1]):
        raise NotImplementedError(f"{conv} under context parallelism")
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return conv2d_rows(x, conv.weight.to(x.dtype), bias, conv.stride[0], conv.padding,
                       conv.groups, state)
