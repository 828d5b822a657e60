"""Flash attention for Hopper (port of
``deepl_project_tpu/ops/pallas/flash_attention.py``).

Two launchers of hand-written CUDA kernels (``deepl_project_tpu_torch/csrc``)
carry the three TPU kernels of that file:

- ``flash_attention_fwd``: o = softmax(q k^T * scale) v and the row
  logsumexp (``_flash_kernel``), a warp-specialised wgmma + TMA tile shared
  with ``attention_core`` through ``flash_fwd_wgmma.cuh``;
- ``flash_attention_bwd``: dq, dk and dv in one wgmma + TMA pass
  (``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``), between two
  small kernels of the same launcher: one computes delta = rowsum(dO * o)
  in fp32 (XLA's work beside the TPU kernels) and zeroes an fp32 dq buffer,
  which the pass sums into by reductions in L2, in an order that changes
  from run to run; the other rounds it to bf16.

Determinism: dk, dv and the forward are the same from run to run; dq is
not, by up to a bf16 step, because of the order of those reductions. Under
``torch.use_deterministic_algorithms(True)`` the backward takes the
launcher's second entry, ``flash_attention_bwd_det``, counted under that
name: each 128-key CTA stores its partial dq into a slot of its own (fp32
[B, h, ceil(N/128), N, 64], so the scratch grows as N^2: 1.5 GiB at
(8, 4096, 6 heads)) and the rounding kernel adds the slots in key order,
so dq, dk and dv are bit-equal from run to run.

:func:`flash_attention` is a ``torch.autograd.Function`` on the port's
[B, N, heads, 64] layout: the forward saves (q, k, v, o, lse) and the
backward launches the backward kernel, as the custom VJP of the JAX
function launches its two. q, k and v are read in place (each with its own
row stride; heads must be adjacent 64-column groups), so neither direction
folds or transposes them.

Lengths: the kernels take a query length and a key length of their own,
any N >= 1 (a ring step's queries against the visiting chunk of an uneven
row split): the maps' rows end at each length, and keys at or past the key
length take no weight (score -inf in the forward; zero P and dS in the
backward, so padded keys get zero dk and dv and padded queries add
nothing). :func:`flash_forward` and :func:`flash_backward` also take the
bounds ``q_len`` / ``k_len`` within longer (padded) tensors: rows past them
are not read, and come back zero (o, dq, dk, dv) or -inf (lse: no weight in
a merge).

For CPU tensors every function runs its plain PyTorch version
(:func:`flash_forward_reference`, :func:`flash_backward_reference`, which
take the same bounds); for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import collections

import torch

from . import build

HEAD_DIM = 64
BLOCK = 64  # tokens per kernel tile (lse and the backward's scratch rows pad to it)
KEY_BLOCK = 128  # keys a CTA of the backward pass: one dq slot each when deterministic

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
    [B, N, heads, 64] tensor, N >= 1."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 4
            and q.shape[-1] == HEAD_DIM and q.shape[1] >= 1)


# -- plain versions ---------------------------------------------------------
def _heads(t: torch.Tensor) -> torch.Tensor:
    """[B, N, h, d] -> [B, h, N, d] in fp32."""
    return t.permute(0, 2, 1, 3).float()


def _bounds(q, k, q_len, k_len) -> tuple[int, int]:
    nq = q.shape[1] if q_len is None else int(q_len)
    nk = k.shape[1] if k_len is None else int(k_len)
    if not (1 <= nq <= q.shape[1] and 1 <= nk <= k.shape[1]):
        raise ValueError(f"flash_attention: bounds ({nq}, {nk}) outside the tensors' "
                         f"({q.shape[1]}, {k.shape[1]}) rows")
    return nq, nk


def _pad_rows(t: torch.Tensor, n: int, dim: int, value: float = 0.0) -> torch.Tensor:
    """``t`` padded along ``dim`` to ``n`` with ``value``."""
    if t.shape[dim] == n:
        return t
    shape = list(t.shape)
    shape[dim] = n - t.shape[dim]
    return torch.cat([t, t.new_full(shape, value)], dim)


def flash_forward_reference(q, k, v, scale, chunk: int = 1024, q_len=None, k_len=None):
    """Plain forward: (o [B, Nq, h, d] in q's dtype, lse [B, h, Nq] fp32).
    fp32 scores, unnormalised p rounded to q's dtype for P.V, division by
    the row sum at the end, lse = m + log(l) (the math of ``_flash_kernel``
    over whole rows); query-chunked to bound the fp32 scores. ``q_len`` /
    ``k_len``: the kernels' length bounds: keys from ``k_len`` on take no
    weight, queries from ``q_len`` on give o = 0 and lse = -inf."""
    nq, nk = _bounds(q, k, q_len, k_len)
    rows_q = q.shape[1]
    q, k, v = q[:, :nq], k[:, :nk], v[:, :nk]
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
    o = o.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return _pad_rows(o, rows_q, 1), _pad_rows(lse, rows_q, 2, float("-inf"))


def flash_backward_reference(q, k, v, o, lse, do, scale, chunk: int = 1024, q_len=None,
                             k_len=None):
    """Plain backward: (dq, dk, dv) in q's dtype from the forward's o and
    lse. p = exp(s - lse) in fp32, delta = rowsum(dO * o) in fp32,
    dv = bf16(p)^T dO, ds = p (dO v^T - delta) scale, dq = bf16(ds) k,
    dk = bf16(ds)^T q (the math of ``_flash_backward``); query-chunked.
    ``q_len`` / ``k_len``: the kernels' length bounds: rows past them read
    nothing and get zero gradients."""
    nq, nk = _bounds(q, k, q_len, k_len)
    rows_q, rows_k = q.shape[1], k.shape[1]
    q, o, do, lse = q[:, :nq], o[:, :nq], do[:, :nq], lse[:, :, :nq]
    k, v = k[:, :nk], v[:, :nk]
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
    dq, dk, dv = (t.to(dt).permute(0, 2, 1, 3).contiguous() for t in (dq, dk, dv))
    return _pad_rows(dq, rows_q, 1), _pad_rows(dk, rows_k, 1), _pad_rows(dv, rows_k, 1)


# -- kernels ----------------------------------------------------------------
def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _rows(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """t as [B, N, h, 64] with adjacent heads and one row stride (a copy
    only when its layout is another: a bounded view of a longer tensor is
    copied); raises on what the kernels do not take."""
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


def _check_shape(q: torch.Tensor, k: torch.Tensor) -> None:
    if (q.dim() != 4 or q.shape[-1] != HEAD_DIM or q.shape[1] < 1 or k.dim() != 4
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:] or k.shape[1] < 1):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (want [B, Nq, heads, {HEAD_DIM}] and "
                         f"[B, Nk, heads, {HEAD_DIM}], Nq, Nk >= 1)")


def flash_forward(q, k, v, scale, q_len=None, k_len=None):
    """(o, lse) of attention of [B, Nq, h, 64] queries over [B, Nk, h, 64]
    keys and values: the ``flash_attention_fwd`` kernel on the card, the
    plain forward on the CPU. o [B, Nq, h, 64] contiguous; lse [B, h, Nq]
    fp32. ``q_len`` / ``k_len``: length bounds within the tensors (module
    docstring)."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale, q_len=q_len, k_len=k_len)
    if q_len is not None or k_len is not None:
        nq, nk = _bounds(q, k, q_len, k_len)
        o, lse = flash_forward(q[:, :nq], k[:, :nk], v[:, :nk], scale)
        return _pad_rows(o, q.shape[1], 1), _pad_rows(lse, q.shape[1], 2, float("-inf"))
    _check_shape(q, k)
    b, n, h, d = q.shape
    nk = k.shape[1]
    q = _rows("q", q, q.shape)
    k, v = (_rows(nm, t, k.shape) for nm, t in (("k", k), ("v", v)))
    o = torch.empty(b, n, h, d, device=q.device, dtype=q.dtype)
    lse = torch.empty(b, h, n, device=q.device, dtype=torch.float32)
    build.launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), b, n, nk, h, q.stride(1), k.stride(1),
                 v.stride(1), h * d, float(scale), _stream())
    _LAUNCHES[("flash_attention_fwd", n, h)] += 1
    return o, lse


def _check_lse(name, t, b, h, n):
    if t.shape != (b, h, n) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be a contiguous fp32 "
                         f"[{b}, {h}, {n}] tensor")


def flash_backward_kernel(q, k, v, o, do, lse, scale):
    """(dq, dk, dv) from the ``flash_attention_bwd`` launcher (CUDA tensors
    only; [B, Nq, h, 64] queries, [B, Nk, h, 64] keys): delta =
    rowsum(dO * o) and a zeroed fp32 [B, h, Lq, 64] dq buffer (Lq: Nq
    rounded up to 64; lse padded to it), the pass, dq rounded to bf16. Under
    ``torch.are_deterministic_algorithms_enabled()``, its deterministic entry
    ``flash_attention_bwd_det`` with one dq slot per 128-key tile."""
    _check_shape(q, k)
    b, n, h, d = q.shape
    nk = k.shape[1]
    q, o, do = (_rows(nm, t, q.shape) for nm, t in (("q", q), ("o", o), ("dO", do)))
    k, v = (_rows(nm, t, k.shape) for nm, t in (("k", k), ("v", v)))
    _check_lse("lse", lse, b, h, n)
    lq = -(-n // BLOCK) * BLOCK
    lse = _pad_rows(lse, lq, 2).contiguous()
    det = torch.are_deterministic_algorithms_enabled()
    name = "flash_attention_bwd_det" if det else "flash_attention_bwd"
    slots = (b, h, -(-nk // KEY_BLOCK)) if det else (b, h)
    delta = torch.empty(b, h, lq, device=q.device, dtype=torch.float32)
    # The pass writes every element of dq_acc: PyTorch's deterministic mode
    # would otherwise fill it (1.5 GiB at the training shape) with NaN first.
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        dq_acc = torch.empty(*slots, lq, d, device=q.device, dtype=torch.float32)
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
    dq = torch.empty(b, n, h, d, device=q.device, dtype=q.dtype)
    dk, dv = (torch.empty(b, nk, h, d, device=q.device, dtype=q.dtype) for _ in range(2))
    build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, nk, h,
                 q.stride(1), k.stride(1), v.stride(1), o.stride(1), do.stride(1), h * d,
                 float(scale), _stream())
    _LAUNCHES[(name, n, h)] += 1
    return dq, dk, dv


def flash_backward(q, k, v, o, lse, do, scale, q_len=None, k_len=None):
    """(dq, dk, dv) from the forward's o and lse and the output gradient:
    the ``flash_attention_bwd`` kernels on the card, the plain backward on
    the CPU. ``q_len`` / ``k_len``: length bounds within the tensors
    (module docstring)."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, scale, q_len=q_len, k_len=k_len)
    if q_len is not None or k_len is not None:
        nq, nk = _bounds(q, k, q_len, k_len)
        dq, dk, dv = flash_backward_kernel(q[:, :nq], k[:, :nk], v[:, :nk], o[:, :nq],
                                           do[:, :nq], lse[:, :, :nq].contiguous(), scale)
        return (_pad_rows(dq, q.shape[1], 1), _pad_rows(dk, k.shape[1], 1),
                _pad_rows(dv, k.shape[1], 1))
    return flash_backward_kernel(q, k, v, o, do, lse, scale)


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
    the backward kernel from the saved o and logsumexp."""
    return _FlashAttention.apply(q, k, v, float(scale))
