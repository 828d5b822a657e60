"""Fused GroupNorm + SiLU on Hopper (port of
``deepl_project_tpu/ops/pallas/fused_norm.py``).

Two hand-written CUDA kernels (``csrc/group_norm_silu.cu``) carry the two TPU
kernels of that file, on the port's NCHW layout:

- ``group_norm_stats`` (``_stats_kernel``): per (image, group) sum(x) and
  sum(x^2) in fp32, as partial sums over contiguous chunks of the group;
- a tiny torch epilogue (the JAX package's XLA epilogue): mean,
  var = max(E[x^2] - mean^2, 0), rsqrt(var + eps), per-channel mul and add;
- ``group_norm_apply`` (``_apply_kernel``): y = silu(x * mul + add) in fp32,
  written in x's dtype.

As in the JAX package, the model does not call it (its ResBlocks use
``ops.norms.GroupNorm`` and a separate SiLU); whether it should is a
measurement for later. It is forward-only, as the JAX function is: asking it
for a gradient raises. For CPU tensors :func:`group_norm_silu` computes the
plain version; for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import collections

import torch

from . import build

_VEC = 8  # values per thread per load in the kernels
_CHUNK = 16384  # values of one group reduced by one stats block
_APPLY_BLOCKS = 132 * 16  # grid-stride blocks of the apply kernel
_THREADS = 256

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
def group_stats_reference(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version of the stats pass: [B, G, 2] fp32 (sum x, sum x^2) per
    (image, group)."""
    b = x.shape[0]
    x32 = x.reshape(b, groups, -1).float()
    return torch.stack([x32.sum(-1), x32.square().sum(-1)], dim=-1)


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
    dtype; mul/add [B, C]."""
    y = x.float() * mul[:, :, None, None] + add[:, :, None, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_reference(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                              silu: bool = True) -> torch.Tensor:
    """Plain version: the port's GroupNorm (fp32 single-pass moments,
    ``ops.norms.GroupNorm``) then SiLU, kept in fp32 until the one cast to
    x's dtype, as the TPU apply kernel does."""
    b, c, h, w = x.shape
    x32 = x.float().reshape(b, groups, -1)
    m1 = x32.mean(dim=-1, keepdim=True)
    m2 = x32.square().mean(dim=-1, keepdim=True)
    var = torch.clamp(m2 - m1.square(), min=0.0)
    y = ((x32 - m1) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# -- kernels ----------------------------------------------------------------
def _dtype_code(x: torch.Tensor) -> int:
    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm_silu: expected a CUDA bf16 or fp32 tensor, "
                         f"got {x.dtype} on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_silu: x must be contiguous NCHW, 16-byte aligned")
    return 1 if x.dtype == torch.bfloat16 else 0


def group_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The ``group_norm_stats`` kernel: [B, G, 2] fp32 (sum x, sum x^2)."""
    b, c, h, w = x.shape
    code = _dtype_code(x)
    group_elems = (c // groups) * h * w
    splits = -(-group_elems // _CHUNK)
    partial = torch.empty(b * groups, splits, 2, device=x.device, dtype=torch.float32)
    build.launch("group_norm_stats", x.data_ptr(), partial.data_ptr(), code,
                 b * groups, splits, group_elems, _CHUNK,
                 torch.cuda.current_stream().cuda_stream)
    _LAUNCHES[("group_norm_stats", h * w, c)] += 1
    return partial.sum(dim=1).reshape(b, groups, 2)


def apply(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
          silu: bool = True) -> torch.Tensor:
    """The ``group_norm_apply`` kernel: silu(x * mul + add), mul/add [B, C]."""
    b, c, h, w = x.shape
    code = _dtype_code(x)
    mul, add = (t.float().contiguous() for t in (mul, add))
    if mul.shape != (b, c) or add.shape != (b, c) or not mul.is_cuda or not add.is_cuda:
        raise ValueError(f"group_norm_apply: mul and add must be CUDA [{b}, {c}] tensors")
    y = torch.empty_like(x)
    total = x.numel()
    blocks = max(1, min(_APPLY_BLOCKS, -(-total // (_VEC * _THREADS))))
    build.launch("group_norm_apply", x.data_ptr(), mul.data_ptr(), add.data_ptr(),
                 y.data_ptr(), code, total, h * w, int(bool(silu)), blocks,
                 torch.cuda.current_stream().cuda_stream)
    _LAUNCHES[("group_norm_apply", h * w, c)] += 1
    return y


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """Fused GroupNorm(+SiLU) on NCHW ``x`` (bf16 or fp32); scale/bias [C]
    fp32 parameters. Forward only."""
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"group_norm_silu: C={c} is not a multiple of groups={groups}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        raise RuntimeError("group_norm_silu is forward-only (the JAX function has "
                           "no VJP either); use ops.norms.GroupNorm and SiLU to train")
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, groups, eps, silu)
    if (h * w) % _VEC:
        raise ValueError(f"group_norm_silu: H*W={h * w} is not a multiple of {_VEC}")
    stats = group_stats(x, groups)
    mul, add = mul_add(stats, (c // groups) * h * w, scale, bias, eps)
    return apply(x, mul, add, silu)
