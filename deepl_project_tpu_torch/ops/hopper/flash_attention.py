"""Flash attention for Hopper (port of
``deepl_project_tpu/ops/pallas/flash_attention.py``).

Three hand-written CUDA kernels (``deepl_project_tpu_torch/csrc``) carry the
three TPU kernels of that file:

- ``flash_attention_fwd``: o = softmax(q k^T * scale) v and the row
  logsumexp (``_flash_kernel``); its tile code is shared with
  ``attention_core`` through ``flash_fwd_tile.cuh``;
- ``flash_attention_bwd_dq``: dq (``_flash_bwd_dq_kernel``);
- ``flash_attention_bwd_dkv``: dk and dv (``_flash_bwd_dkv_kernel``).

:func:`flash_attention` is a ``torch.autograd.Function`` on the port's
[B, N, heads, 64] layout: the forward saves (q, k, v, o, lse) and the
backward launches dq and dk/dv, as the custom VJP of the JAX function does.
q, k and v are read in place (each with its own row stride; heads must be
adjacent 64-column groups), so neither direction folds or transposes them.
delta = rowsum(dO * o) is a plain fp32 reduction beside the kernels, as it is
XLA beside the TPU kernels.

For CPU tensors every function runs its plain PyTorch version
(:func:`flash_forward_reference`, :func:`flash_backward_reference`); for a
CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import collections

import torch

from . import build

HEAD_DIM = 64
BLOCK = 64  # tokens per kernel tile: N must be a multiple

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


def flash_supported(q: torch.Tensor) -> bool:
    """The kernels' own limits (the port's ``pallas_ok``): a CUDA bf16
    [B, N, heads, 64] tensor with N % 64 == 0."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 4
            and q.shape[-1] == HEAD_DIM and q.shape[1] % BLOCK == 0)


# -- plain versions ---------------------------------------------------------
def _heads(t: torch.Tensor) -> torch.Tensor:
    """[B, N, h, d] -> [B, h, N, d] in fp32."""
    return t.permute(0, 2, 1, 3).float()


def flash_forward_reference(q, k, v, scale, chunk: int = 1024):
    """Plain forward: (o [B, N, h, d] in q's dtype, lse [B, h, N] fp32).
    fp32 scores, unnormalised p rounded to q's dtype for P.V, division by
    the row sum at the end, lse = m + log(l) (the math of ``_flash_kernel``
    over whole rows); query-chunked to bound the fp32 scores."""
    b, n, h, d = q.shape
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    kt = kh.transpose(-1, -2)
    o = torch.empty(b, h, n, d, device=q.device)
    lse = torch.empty(b, h, n, device=q.device)
    for r0 in range(0, n, chunk):
        rows = slice(r0, r0 + chunk)
        s = (qh[:, :, rows] @ kt) * scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        del s
        l = p.sum(dim=-1, keepdim=True)
        o[:, :, rows] = (p.to(q.dtype).float() @ vh) / l
        lse[:, :, rows] = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype).permute(0, 2, 1, 3).contiguous(), lse


def flash_backward_reference(q, k, v, o, lse, do, scale, chunk: int = 1024):
    """Plain backward: (dq, dk, dv) in q's dtype from the forward's o and
    lse. p = exp(s - lse) in fp32, delta = rowsum(dO * o) in fp32,
    dv = bf16(p)^T dO, ds = p (dO v^T - delta) scale, dq = bf16(ds) k,
    dk = bf16(ds)^T q (the math of ``_flash_backward``); query-chunked."""
    dt = q.dtype
    qh, kh, vh, gh = _heads(q), _heads(k), _heads(v), _heads(do)
    delta = (gh * _heads(o)).sum(dim=-1)
    kt, vt = kh.transpose(-1, -2), vh.transpose(-1, -2)
    dq = torch.empty_like(qh)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    for r0 in range(0, q.shape[1], chunk):
        rows = slice(r0, r0 + chunk)
        p = torch.exp((qh[:, :, rows] @ kt) * scale - lse[:, :, rows, None])
        dv += p.to(dt).float().transpose(-1, -2) @ gh[:, :, rows]
        ds = p * ((gh[:, :, rows] @ vt) - delta[:, :, rows, None]) * scale
        del p
        ds = ds.to(dt).float()
        dq[:, :, rows] = ds @ kh
        dk += ds.transpose(-1, -2) @ qh[:, :, rows]
    return tuple(t.to(dt).permute(0, 2, 1, 3).contiguous() for t in (dq, dk, dv))


# -- kernels ----------------------------------------------------------------
def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _rows(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """t as [B, N, h, 64] with adjacent heads and one row stride (a copy
    only when its layout is another); raises on what the kernels do not
    take."""
    if not t.is_cuda or t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention {name}: expected a CUDA bf16 tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention {name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    b, n = shape[0], shape[1]
    if (t.stride(3) != 1 or t.stride(2) != HEAD_DIM or t.stride(1) % 8
            or (b > 1 and t.stride(0) != n * t.stride(1)) or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _check_shape(q: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM or q.shape[1] % BLOCK:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)} "
                         f"(want [B, N, heads, {HEAD_DIM}] with N % {BLOCK} == 0)")


def flash_forward(q, k, v, scale):
    """(o, lse) of attention on [B, N, h, 64] tensors: the
    ``flash_attention_fwd`` kernel on the card, the plain forward on the
    CPU. o [B, N, h, 64] contiguous; lse [B, h, N] fp32."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale)
    _check_shape(q)
    b, n, h, d = q.shape
    q, k, v = (_rows(nm, t, q.shape) for nm, t in (("q", q), ("k", k), ("v", v)))
    o = torch.empty(b, n, h, d, device=q.device, dtype=q.dtype)
    lse = torch.empty(b, h, n, device=q.device, dtype=torch.float32)
    build.launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), b, n, h, q.stride(1), k.stride(1),
                 v.stride(1), h * d, float(scale), _stream())
    _LAUNCHES[("flash_attention_fwd", n, h)] += 1
    return o, lse


def _check_lse(name, t, b, h, n):
    if t.shape != (b, h, n) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be a contiguous fp32 "
                         f"[{b}, {h}, {n}] tensor")


def flash_delta(o, do):
    """delta = rowsum(dO * o) in fp32, [B, h, N]: the backward's per-row term
    (a plain reduction, as it is XLA beside the TPU kernels)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_backward_dq(q, k, v, do, lse, delta, scale):
    """dq from the ``flash_attention_bwd_dq`` kernel (CUDA tensors only)."""
    _check_shape(q)
    b, n, h, d = q.shape
    q, k, v, do = (_rows(nm, t, q.shape) for nm, t in
                   (("q", q), ("k", k), ("v", v), ("dO", do)))
    _check_lse("lse", lse, b, h, n)
    _check_lse("delta", delta, b, h, n)
    dq = torch.empty(b, n, h, d, device=q.device, dtype=q.dtype)
    build.launch("flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 b, n, h, q.stride(1), k.stride(1), v.stride(1), do.stride(1),
                 h * d, float(scale), _stream())
    _LAUNCHES[("flash_attention_bwd_dq", n, h)] += 1
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, scale):
    """(dk, dv) from the ``flash_attention_bwd_dkv`` kernel (CUDA tensors
    only)."""
    _check_shape(q)
    b, n, h, d = q.shape
    q, k, v, do = (_rows(nm, t, q.shape) for nm, t in
                   (("q", q), ("k", k), ("v", v), ("dO", do)))
    _check_lse("lse", lse, b, h, n)
    _check_lse("delta", delta, b, h, n)
    dk, dv = (torch.empty(b, n, h, d, device=q.device, dtype=q.dtype) for _ in range(2))
    build.launch("flash_attention_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, n, h, q.stride(1), k.stride(1), v.stride(1),
                 do.stride(1), h * d, float(scale), _stream())
    _LAUNCHES[("flash_attention_bwd_dkv", n, h)] += 1
    return dk, dv


def flash_backward(q, k, v, o, lse, do, scale):
    """(dq, dk, dv) from the forward's o and lse and the output gradient:
    the ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` kernels
    on the card, the plain backward on the CPU."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, scale)
    _check_shape(q)
    do = _rows("dO", do, q.shape)
    delta = flash_delta(_rows("o", o, q.shape), do)
    dq = flash_backward_dq(q, k, v, do, lse, delta, scale)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, N, heads, 64] tensors (the layout of
    ``ops.attention.xla_attention``), differentiable: the backward launches
    the dq and dk/dv kernels from the saved o and logsumexp."""
    return _FlashAttention.apply(q, k, v, float(scale))
