"""Ring (context-parallel) attention over a row-sharded token axis (PyTorch
port of ``parallel/ring_attention.py``).

Each rank of the context group holds [B, N_c, h, d] q, k and v: its rows
of every image's tokens, N_c for rank c by the row split of
``parallel.context`` (equal, or short or empty on the trailing ranks: the
``sizes`` every function here takes). K/V chunks travel around the ring
(:func:`ring_shift`, the ``ppermute`` counterpart: send to (i + 1) mod n,
receive from (i - 1) mod n, each step's buffer at the size of the chunk it
receives; an empty chunk is not sent) and each rank merges its queries'
attention over every chunk, so the result is exact softmax(q k^T) v over
the global token axis.

- :class:`RingAttention` (``torch.autograd.Function``) computes each
  step's partial (o_i, lse_i) of the local queries against the visiting
  chunk with the flash forward kernel (``ops/hopper/flash_attention.py``)
  and merges in fp32: lse = logaddexp(lse_acc, lse_i), o = o_acc
  e^(lse_acc - lse) + o_i e^(lse_i - lse). Its backward runs the ring
  again: each step's flash backward reads the *merged* o and lse, so the
  kernel's delta = rowsum(dO o) and p = exp(s - lse) are the global ones and
  each step's dq, dk and dv are exact partials; dq sums in place, and the
  fp32 dk/dv accumulators travel with their K/V chunk and come home after
  the last shift. The kernels take a query and a key length of their own,
  any N (a length bound masks the keys past the chunk), so every step of a
  CUDA bf16 ring runs on them, equal chunks or not; a step whose queries or
  keys are empty runs nothing. On CPU tensors (and CUDA fp32, which the
  kernels do not take) the partials are the plain
  ``flash_forward_reference`` / ``flash_backward_reference``; a CUDA bf16
  head width the kernels refuse (not 64) raises.
- :func:`ring_attention_reference`: the plain version with the JAX
  function's math: the unnormalised fp32 (m, l, o) carry, p rounded to v's
  dtype for P V, query chunks of 2048 rows.
- :func:`context_parallel_attention`: the dispatch ``AttentionRoPE`` calls
  under an ambient context group, the ring wherever the token axis splits
  (the JAX module takes the ring where the global token count divides C
  and the whole map otherwise; both are exact);
  :func:`sequence_parallel_attention` takes whole tensors, as the JAX
  function does.

One deviation from the JAX ring: each step's partial o leaves the flash
kernel rounded to bf16 before the fp32 merge (the JAX ring keeps its fp32
P V products), within the kernels' own bar of the single-process flash
attention.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from ..ops.hopper.flash_attention import (flash_backward, flash_backward_reference,
                                          flash_forward, flash_forward_reference,
                                          flash_supported)
from .collectives import all_gather_cat, send_recv
from .context import current

# Above this local query length each step's plain partial runs in query
# chunks (the JAX function's _RING_Q_CHUNK).
_RING_Q_CHUNK = 2048

# 'forward' / 'backward' -> ring steps since the last reset.
_STEPS: collections.Counter = collections.Counter()


def reset_step_counts() -> None:
    _STEPS.clear()


def step_counts() -> dict[str, int]:
    return dict(_STEPS)


def ring_shift(tensors, group, incoming: int | None = None):
    """``tensors`` (one tensor or a list; dim 1 the token axis) sent to the
    next rank of the ring, (i + 1) mod n, and the previous rank's received
    in their place: one batch of point-to-point transfers
    (``collectives.send_recv``). ``incoming``: the token count of the
    chunk this rank receives (default: its own); an empty chunk is neither
    sent nor received."""
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if size == 1:
        return tensors
    n = ts[0].shape[1] if incoming is None else incoming
    got = [torch.empty((t.shape[0], n) + tuple(t.shape[2:]), dtype=t.dtype, device=t.device)
           for t in ts]
    sends = [(t, (rank + 1) % size) for t in ts if t.shape[1]]
    recvs = [(g, (rank - 1) % size) for g in got if n]
    send_recv(sends, recvs, group)
    return got[0] if single else got


def _partials(q: torch.Tensor, plain: bool):
    """(forward, backward) partial functions for q: the flash kernels, or
    their plain versions on CPU tensors, CUDA fp32 or when ``plain``."""
    if plain or not q.is_cuda or q.dtype != torch.bfloat16:
        return flash_forward_reference, flash_backward_reference
    if not flash_supported(q):
        raise ValueError(f"ring attention: the flash kernels refuse the local shape "
                         f"{tuple(q.shape)} (want [B, N_local, heads, 64])")
    return flash_forward, flash_backward


def _merge(o_acc, lse_acc, o_i, lse_i):
    """The online-softmax merge in fp32: o [B, N, h, d], lse [B, h, N]."""
    lse = torch.logaddexp(lse_acc, lse_i)
    w_acc = torch.exp(lse_acc - lse).transpose(1, 2)[..., None]
    w_i = torch.exp(lse_i - lse).transpose(1, 2)[..., None]
    return o_acc * w_acc + o_i.float() * w_i, lse


def _chunk_sizes(q: torch.Tensor, group, sizes) -> list[int]:
    """Every rank's token count (``sizes``, default all equal to q's)."""
    n = dist.get_world_size(group)
    sizes = [q.shape[1]] * n if sizes is None else [int(s) for s in sizes]
    if len(sizes) != n or sizes[dist.get_rank(group)] != q.shape[1]:
        raise ValueError(f"ring attention: chunk sizes {sizes} do not fit this rank's "
                         f"{q.shape[1]} tokens over {n} ranks")
    return sizes


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, group, plain, sizes):
        fwd, bwd = _partials(q, plain)
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        o_acc = lse_acc = None
        k_cur, v_cur = k, v
        for step in range(n):
            if q.shape[1] and k_cur.shape[1]:
                o_i, lse_i = fwd(q, k_cur, v_cur, scale)
                if o_acc is None:
                    o_acc, lse_acc = o_i.float(), lse_i
                else:
                    o_acc, lse_acc = _merge(o_acc, lse_acc, o_i, lse_i)
            _STEPS["forward"] += 1
            if step < n - 1:
                k_cur, v_cur = ring_shift([k_cur, v_cur], group, sizes[(rank - step - 1) % n])
        if o_acc is None:  # no queries on this rank
            o = torch.empty_like(q)
            lse_acc = q.new_empty((q.shape[0], q.shape[2], 0), dtype=torch.float32)
        else:
            o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse_acc.contiguous())
        ctx.scale, ctx.group, ctx.bwd, ctx.sizes = scale, group, bwd, sizes
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, sizes = ctx.group, ctx.sizes
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        do = do.contiguous()
        for step in range(n):
            if q.shape[1] and k_cur.shape[1]:
                dq_i, dk_i, dv_i = ctx.bwd(q, k_cur, v_cur, o, lse, do, ctx.scale)
                dq += dq_i.float()
                dk_acc += dk_i.float()
                dv_acc += dv_i.float()
            _STEPS["backward"] += 1
            # The accumulators travel with their chunk: n shifts bring them home.
            incoming = sizes[(rank - step - 1) % n]
            if step < n - 1:
                k_cur, v_cur, dk_acc, dv_acc = ring_shift([k_cur, v_cur, dk_acc, dv_acc], group,
                                                          incoming)
            else:
                dk_acc, dv_acc = ring_shift([dk_acc, dv_acc], group, incoming)
        return (dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype), None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, group,
                   plain: bool = False, sizes=None) -> torch.Tensor:
    """Exact attention of this rank's [B, N_local, h, d] queries over the
    global token axis sharded over ``group``; differentiable. ``plain``:
    the plain partials on any device (the kernels' reference on the card).
    ``sizes``: every rank's token count (default: all N_local)."""
    sizes = _chunk_sizes(q, group, sizes)
    return RingAttention.apply(q, k, v, float(scale), group, plain, sizes)


def ring_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float, group, sizes=None) -> torch.Tensor:
    """The plain ring with the JAX function's math (not differentiated):
    per step, fp32 logits, m = max, p = exp(s - m) rounded to v's dtype for
    P V (fp32 accumulation), l = sum(p) in fp32; the carry (m, l, o) merged
    unnormalised; o / l at the end; local queries in chunks of
    ``_RING_Q_CHUNK`` rows when N_local is a larger multiple of it."""
    b, nq, h, d = q.shape
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    sizes = _chunk_sizes(q, group, sizes)
    qh = q.permute(0, 2, 1, 3)  # [B, h, Nq, d]
    chunk = _RING_Q_CHUNK if nq > _RING_Q_CHUNK and nq % _RING_Q_CHUNK == 0 else max(nq, 1)
    m_acc = torch.full((b, h, nq, 1), float("-inf"), device=q.device)
    l_acc = torch.zeros(b, h, nq, 1, device=q.device)
    o_acc = torch.zeros(b, h, nq, d, device=q.device)
    k_cur, v_cur = k, v
    with torch.no_grad():
        for step in range(n):
            kt = k_cur.permute(0, 2, 3, 1).float()  # [B, h, d, Nk]
            vh = v_cur.permute(0, 2, 1, 3)
            for r0 in range(0, nq if kt.shape[-1] else 0, chunk):
                rows = slice(r0, r0 + chunk)
                s = (qh[:, :, rows].float() @ kt) * scale
                m = s.amax(dim=-1, keepdim=True)
                p = torch.exp(s - m)
                del s
                l = p.sum(dim=-1, keepdim=True)
                o = p.to(v.dtype).float() @ vh.float()
                m_tot = torch.maximum(m_acc[:, :, rows], m)
                alpha, beta = torch.exp(m_acc[:, :, rows] - m_tot), torch.exp(m - m_tot)
                l_acc[:, :, rows] = alpha * l_acc[:, :, rows] + beta * l
                o_acc[:, :, rows] = alpha * o_acc[:, :, rows] + beta * o
                m_acc[:, :, rows] = m_tot
            if step < n - 1:
                k_cur, v_cur = ring_shift([k_cur, v_cur], group, sizes[(rank - step - 1) % n])
    return (o_acc / l_acc).to(q.dtype).permute(0, 2, 1, 3)


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float, group=None, sizes=None) -> torch.Tensor:
    """Ring attention over ``group`` (default: the ambient context group,
    ``parallel.context``) on this rank's [B, N_local, h, d] tensors, every
    rank's token count ``sizes`` (default: equal): the core
    ``AttentionRoPE`` runs under context parallelism."""
    if group is None:
        group = current().group
    return ring_attention(q, k, v, scale, group, sizes=sizes)


def sequence_parallel_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float, axis: str = "data") -> torch.Tensor:
    """Ring attention on whole [B, N, h, d] tensors, the token axis sharded
    over ``mesh``'s ``axis`` (N % its size == 0): this rank takes its chunk,
    runs the ring and all-gathers the whole result, as the JAX function
    returns the global array."""
    group = mesh.get_group(axis)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if q.shape[1] % size:
        raise ValueError(f"{q.shape[1]} tokens do not split over {size} ranks")
    local = [t.chunk(size, 1)[rank].contiguous() for t in (q, k, v)]
    return all_gather_cat(ring_attention(*local, scale, group), 1, group)
