"""Whole-head attention for token axes up to N=1024 on Hopper (port of
``deepl_project_tpu/ops/pallas/small_attention.py``).

One hand-written CUDA kernel (``csrc/small_attention.cu``) carries the TPU
kernel ``_kernel``: fp32 scores, the exact row softmax, the weights
normalised and *then* rounded to bf16, P.V accumulated in fp32 (the flash
kernels round the unnormalised weights instead). The TPU keeps a head's
whole [N, N] score block in VMEM; the CUDA kernel runs two passes over the
keys per 64-query tile instead (row max and sum, then the weights and P.V),
with wgmma products fed by TMA loads.

:func:`small_attention` takes [B, N, heads, 64] tensors (the layout of
``ops.attention.xla_attention``), each with its own row stride, so q, k and v
may be column slices of one [B, N, 3C] buffer. It is a
``torch.autograd.Function`` whose backward is the VJP of the plain version
(the JAX package's ``_make_op``). For CPU tensors it computes the plain
version; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import collections

import torch

from . import build
from .flash_attention import _rows

HEAD_DIM = 64
BLOCK = 64  # keys per kernel tile: N must be a multiple
MAX_SMALL_N = 1024  # the TPU kernel's limit (its fp32 N x N scores in VMEM)

# (kernel name, tokens per image, heads) -> launches since the last reset.
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
    """(kernel name, N, heads) -> launches since the last reset."""
    return dict(_LAUNCHES)


def small_attention_supported(n: int, heads: int, head_dim: int) -> bool:
    """The kernel's limits: head_dim 64, 0 < N <= 1024 (the TPU kernel's
    limit) with N % 64 == 0 (64-key tiles), at most 65535 heads (a grid
    axis)."""
    return (head_dim == HEAD_DIM and 0 < n <= MAX_SMALL_N and n % BLOCK == 0
            and 0 < heads < 65536)


def small_attention_reference(q, k, v, scale):
    """Plain version (the math of ``_xla_reference``): [B, N, h, d] x3 ->
    [B, N, h, d] in v's dtype; fp32 scores and softmax, the normalised
    weights rounded to v's dtype, P.V with fp32 accumulation."""
    qh, kh = (t.permute(0, 2, 1, 3).float() for t in (q, k))
    weights = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, dim=-1)
    out = weights.to(v.dtype).float() @ v.permute(0, 2, 1, 3).float()
    return out.to(v.dtype).permute(0, 2, 1, 3)


def _kernel(q, k, v, scale):
    """Launch ``small_attention``: o [B, N, h, 64] contiguous."""
    b, n, h, d = q.shape
    if not small_attention_supported(n, h, d):
        raise ValueError(f"small_attention: unsupported shape {tuple(q.shape)} "
                         f"(want [B, N, heads, {HEAD_DIM}] with N % {BLOCK} == 0)")
    q, k, v = (_rows(nm, t, q.shape) for nm, t in (("q", q), ("k", k), ("v", v)))
    o = torch.empty(b, n, h, d, device=q.device, dtype=q.dtype)
    build.launch("small_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), b, n, h, q.stride(1), k.stride(1), v.stride(1),
                 h * d, float(scale), torch.cuda.current_stream().cuda_stream)
    _LAUNCHES[("small_attention", n, h)] += 1
    return o


class _SmallAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version under
    autograd and returns its VJP."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _kernel(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(
                small_attention_reference(*ins, ctx.scale), wrt, do))
        return (*[next(grads) if t.requires_grad else None for t in ins], None)


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Attention for N <= 1024: q/k/v [B, N, heads, head_dim] -> same shape.
    Longer token axes raise, as in the JAX package (use flash_attention)."""
    if q.shape[1] > MAX_SMALL_N:
        raise ValueError(
            f"small_attention supports N <= {MAX_SMALL_N}; got N={q.shape[1]}"
            " -- use flash_attention (blockwise) for longer token axes")
    if q.device.type == "cpu":
        return small_attention_reference(q, k, v, scale)
    return _SmallAttention.apply(q, k, v, float(scale))
