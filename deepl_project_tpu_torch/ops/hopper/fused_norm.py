"""Fused GroupNorm + SiLU on Hopper (port of
``deepl_project_tpu/ops/pallas/fused_norm.py``).

Two hand-written CUDA kernels (``csrc/group_norm_silu.cu``) carry the two TPU
kernels of that file on their own layout, a channels_last map ([B, H*W, C]
in memory), with the XLA epilogue between them folded into the second:

- ``group_norm_stats`` (``_stats_kernel``): per-(image, channel) sum(x) and
  sum(x^2) in fp32, one partial pair per block of rows;
- ``group_norm_apply`` (``_apply_kernel`` and the epilogue): each block
  folds an image's partials into per-group mean, var = max(E[x^2] - mean^2,
  0), rsqrt(var + eps) and per-channel mul and add, then writes
  y = silu(x * mul + add), computed in fp32 and rounded once to x's dtype.

The model calls it through ``ops.norms.group_norm_silu`` where
:func:`group_norm_silu_supported` holds (no-grad CUDA bf16); a map there
that is not channels_last raises.
It is forward-only, as the JAX function is: asking it for a gradient raises.
For CPU tensors :func:`group_norm_silu` computes the plain version, in any
memory format; for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import collections
import functools
import math

import torch

from . import build

_VEC = 8  # channels per thread per load in the kernels
_MAX_C = 2048  # (C/8) * k <= 256 threads cover a row
_BLOCKS_PER_SM = 4  # both kernels' __launch_bounds__(256, 4)

# (kernel name, H*W, C) -> launches since the last reset.
_LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last reset."""
    out: dict[str, int] = {}
    for (name, _, _), cnt in _LAUNCHES.items():
        out[name] = out.get(name, 0) + cnt
    return out


def launch_counts_by_shape() -> dict[tuple, int]:
    """(kernel name, H*W, C) -> launches since the last reset."""
    return dict(_LAUNCHES)


# -- plain versions ---------------------------------------------------------
def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, H*W, C] fp32: a view of a channels_last map, a copy otherwise."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c).float()


def channel_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the stats pass (``_stats_kernel``): [B, 2, C] fp32,
    sum x and sum x^2 per (image, channel)."""
    x32 = _rows(x)
    return torch.stack([x32.sum(1), x32.square().sum(1)], dim=1)


def group_stats_reference(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, G, 2] fp32 (sum x, sum x^2) per (image, group): the channel sums
    added over each group's channels, as the epilogue adds them."""
    return group_sums(channel_stats_reference(x), groups)


def group_sums(channel_stats: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, 2, C] per-channel sums -> [B, G, 2] per-group sums."""
    b, _, c = channel_stats.shape
    return channel_stats.reshape(b, 2, groups, c // groups).sum(-1).transpose(1, 2)


def mul_add(stats: torch.Tensor, count: int, scale, bias, eps: float):
    """The epilogue: per-(image, group) sums -> per-(image, channel) mul and
    add, [B, C] fp32 each (``fused_norm.py``'s XLA epilogue)."""
    c = scale.shape[0]
    cg = c // stats.shape[1]
    mean = stats[..., 0] / count
    var = torch.clamp(stats[..., 1] / count - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    mul = inv.repeat_interleave(cg, dim=1) * scale.float()[None]
    add = bias.float()[None] - mean.repeat_interleave(cg, dim=1) * mul
    return mul, add


def apply_reference(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                    silu: bool = True) -> torch.Tensor:
    """Plain version of the apply pass: silu(x * mul + add) in fp32, in x's
    dtype and memory format; mul/add [B, C]."""
    y = x.float() * mul[:, :, None, None] + add[:, :, None, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_reference(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                              silu: bool = True) -> torch.Tensor:
    """Plain version: the port's GroupNorm (fp32 single-pass moments,
    ``ops.norms.GroupNorm``) then SiLU, kept in fp32 until the one cast to
    x's dtype, as the TPU apply kernel does; any memory format in, the
    same out."""
    b, c, h, w = x.shape
    x32 = _rows(x).reshape(b, h * w, groups, c // groups)
    m1 = x32.mean(dim=(1, 3), keepdim=True)
    m2 = x32.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(m2 - m1.square(), min=0.0)
    y = ((x32 - m1) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = y * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return y.to(x.dtype).permute(0, 3, 1, 2).contiguous(memory_format=fmt)


# -- the gate ---------------------------------------------------------------
def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def _layout_error(x: torch.Tensor, groups: int) -> str | None:
    """Why the kernels cannot take ``x`` (None if they can): a non-empty 4-D
    bf16 or fp32 channels_last map, 16-byte aligned, C % 8 == 0,
    C % groups == 0, C <= 2048."""
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32) or not x.numel():
        return f"expected a non-empty 4-D bf16 or fp32 map, got {x.dtype} {tuple(x.shape)}"
    c = x.shape[1]
    if not x.is_contiguous(memory_format=torch.channels_last):
        return (f"x must be channels_last (NHWC in memory); got shape {tuple(x.shape)} "
                f"strides {x.stride()}")
    if c % _VEC or c > _MAX_C or c % groups:
        return f"C={c} must be a multiple of {_VEC} and of groups={groups}, at most {_MAX_C}"
    if x.data_ptr() % 16:
        return "x must be 16-byte aligned"
    return None


def group_norm_silu_supported(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """The model's gate (``ops.norms.group_norm_silu``): ``x`` a bf16 CUDA
    map and no gradient asked of ``x`` or of the norm's ``params``. The
    layout is not asked: :func:`group_norm_silu` raises on a map the
    kernels cannot take."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not _needs_grad(x, *params)


# -- kernels ----------------------------------------------------------------
def _check(x: torch.Tensor, groups: int) -> int:
    """Raise unless the kernels take ``x`` on the card; its dtype code."""
    err = _layout_error(x, groups)
    if err is not None:
        raise ValueError(f"group_norm_silu: {err}")
    if not x.is_cuda:
        raise ValueError(f"group_norm_silu: expected a CUDA tensor, got one on {x.device}")
    return 1 if x.dtype == torch.bfloat16 else 0


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int) -> int:
    """Blocks of either kernel the card holds at once."""
    return _BLOCKS_PER_SM * torch.cuda.get_device_properties(device_index).multi_processor_count


def _rows_per_slab(x: torch.Tensor) -> int:
    """Rows of one block of either kernel's (slabs, B) grid: about one
    resident wave of blocks, with slabs^2 <= H*W / 40 so that each apply
    block's fold (slabs * 2C fp32 reads) stays a few percent of its bytes."""
    b, _, h, w = x.shape
    hw = h * w
    slabs = max(1, min(_resident_blocks(x.device.index) // b, math.isqrt(hw // 40)))
    return -(-hw // slabs)


def stats(x: torch.Tensor) -> torch.Tensor:
    """The ``group_norm_stats`` kernel: per-(image, slab, channel) partial
    sums, [B, slabs, 2, C] fp32 (sum x, sum x^2)."""
    code = _check(x, 1)
    b, c, h, w = x.shape
    rows = _rows_per_slab(x)
    partial = torch.empty(b, -(-h * w // rows), 2, c, device=x.device, dtype=torch.float32)
    build.launch("group_norm_stats", x.data_ptr(), partial.data_ptr(), code, b, h * w, c,
                 rows, torch.cuda.current_stream().cuda_stream)
    _LAUNCHES[("group_norm_stats", h * w, c)] += 1
    return partial


def apply(x: torch.Tensor, partial: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
          groups: int, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """The ``group_norm_apply`` kernel: each block folds its image's
    ``partial`` (from :func:`stats`) into mul/add, then y = silu(x * mul +
    add) in x's dtype and memory format. ``scale``/``bias``: [C] fp32 CUDA
    tensors."""
    code = _check(x, groups)
    b, c, h, w = x.shape
    rows = _rows_per_slab(x)
    slabs = -(-h * w // rows)
    if (partial.shape != (b, slabs, 2, c) or partial.dtype != torch.float32
            or not partial.is_contiguous()):
        raise ValueError(f"group_norm_apply: partial must be contiguous fp32 "
                         f"[{b}, {slabs}, 2, {c}] (stats of this map: {slabs} slabs), got "
                         f"{partial.dtype} {tuple(partial.shape)}")
    for t in (scale, bias):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"group_norm_apply: scale and bias must be contiguous CUDA "
                             f"fp32 [{c}], got {t.dtype} {tuple(t.shape)} on {t.device}")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    build.launch("group_norm_apply", x.data_ptr(), partial.data_ptr(), slabs,
                 scale.data_ptr(), bias.data_ptr(), y.data_ptr(), code, b, h * w, c, groups,
                 rows, float(eps), int(bool(silu)),
                 torch.cuda.current_stream().cuda_stream)
    _LAUNCHES[("group_norm_apply", h * w, c)] += 1
    return y


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """Fused GroupNorm(+SiLU) on ``x`` [B, C, H, W] (bf16 or fp32; on CUDA
    channels_last); scale/bias [C] parameters. Forward only: two launches
    on the card, nothing between them."""
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"group_norm_silu: C={c} is not a multiple of groups={groups}")
    if _needs_grad(x, scale, bias):
        raise RuntimeError("group_norm_silu is forward-only (the JAX function has "
                           "no VJP either); use ops.norms.GroupNorm and SiLU to train")
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, groups, eps, silu)
    scale, bias = (t.detach().float().contiguous() for t in (scale, bias))
    return apply(x, stats(x), scale, bias, groups, eps, silu)
