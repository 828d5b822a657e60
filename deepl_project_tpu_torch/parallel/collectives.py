"""The collectives of the port's parallel training, as autograd functions
over a process group (no JAX counterpart: there GSPMD inserts them).

The training steps take gradients with ``torch.autograd.grad`` on explicit
parameter lists, so nothing here hooks ``.backward()`` on a wrapped module
(as DDP's reducer and FSDP2's reduce-scatter do); each collective is an
operation of the forward whose backward is the collective its derivative
needs. Every rank of a model group sees the same rows and computes the same
loss, so the gradient of a tensor every peer holds whole is the same on
every peer:

- :func:`copy_to_group` (Megatron's f): identity forward, all-reduce (sum)
  backward -- ahead of a layer whose weight is split over the group, whose
  input gradient each peer holds only in part;
- :func:`reduce_from_group` (Megatron's g): all-reduce (sum) forward,
  identity backward -- after a row-parallel layer's partial products;
- :func:`gather_from_group`: all-gather along a dimension; its backward
  takes this rank's slice of a gradient every peer holds whole (an FSDP
  weight, a channel map whose consumers are replicated), or with
  ``reduce_grad`` reduce-scatters a gradient each peer holds in part;
- :func:`scatter_to_group`: this rank's slice forward, all-gather backward;
- :func:`reduce_scatter`: reduce-scatter (sum) forward, all-gather backward;
- :func:`global_mean`: the mean of a per-rank mean over the data group,
  whose backward passes the gradient through unscaled, so that after the
  gradient all-reduce (a mean over data) each rank's rows carry the
  single-process gradient of a term that depends on the whole batch (the
  VF hinge);
- :func:`sum_over_group`: all-reduce (sum) forward and backward -- a sum
  that every rank then uses on rows of its own (context parallelism's
  GroupNorm moments), whose gradient is the sum of every rank's;
- :func:`gather_rows`: :func:`gather_from_group` over parts of unequal
  sizes (context parallelism's uneven row split): each part padded to the
  largest for the all-gather and trimmed after;
- :func:`fetch_rows`: global rows [a, b) of a map split over the group,
  from whichever ranks hold them, zeros outside the map; its backward sends
  each row's gradient home and adds it there (the halo rows of a
  convolution, the row pairs of a pool, a change of split).

:func:`send_recv` is the point-to-point exchange of context parallelism
(the halo rows, the ring's K/V chunks): one batch of sends and receives
within a group. A gloo group given CUDA tensors stages them through host
memory (gloo's transport refuses device pointers), an explicit branch on
the group's backend counted in :func:`staged_counts` (the card's one
device holds two ranks only over gloo); NCCL sends them as they are. The
collectives of CUDA tensors over a gloo group, which gloo itself copies
through host memory, are counted there too (their results' bytes).

:func:`all_gather_cat`, :func:`all_reduce_sum` and :func:`rank_slice` are
the same collectives outside autograd (whole state from slices, sums of
sharded statistics, this rank's slice of a whole tensor);
:func:`all_reduce_mean_` averages gradient lists over the data group in
flat fp32 buckets; :func:`reduce_metrics` averages logged metrics.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# Elements per flat bucket of the gradient all-reduce (1 GiB of fp32).
BUCKET_NUMEL = 1 << 28


def _size(group) -> int:
    return dist.get_world_size(group)


def _count_staged(out: torch.Tensor, group) -> None:
    """Count a collective's result ``out`` as staged where gloo copies it
    through host memory (a CUDA tensor on a gloo group)."""
    if out.is_cuda and dist.get_backend(group) == "gloo":
        _STAGED["collectives"] += 1
        _STAGED["collective_bytes"] += out.numel() * out.element_size()


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    _count_staged(out, group)
    return out


def rank_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (storage of its own)."""
    return x.chunk(_size(group), dim)[dist.get_rank(group)].clone(
        memory_format=torch.contiguous_format)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [t.contiguous() for t in x.chunk(_size(group), dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group`` (a new tensor)."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    _count_staged(x, group)
    return x


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        part = (_reduce_scatter(g, ctx.dim, ctx.group) if ctx.reduce_grad
                else rank_slice(g, ctx.dim, ctx.group))
        return part, None, None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return rank_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _GlobalMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group) / _size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group, reduce_grad: bool = False
                      ) -> torch.Tensor:
    return _GatherFromGroup.apply(x, dim, group, reduce_grad)


def scatter_to_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _ScatterToGroup.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _ReduceScatter.apply(x, dim, group)


def global_mean(x: torch.Tensor, group) -> torch.Tensor:
    return _GlobalMean.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOverGroup.apply(x, group)


def _narrow_pad(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` padded with zeros along ``dim`` to ``size``."""
    if x.shape[dim] == size:
        return x.contiguous()
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim).contiguous()


def part_sizes(n: int, group, device) -> list[int]:
    """Every rank's ``n`` over ``group`` (one all-gather)."""
    t = torch.tensor([n], dtype=torch.int64, device=device)
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t, group=group)
    return [int(p.item()) for p in parts]


def all_gather_uneven(x: torch.Tensor, dim: int, group, sizes: list[int]) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim``, rank c's
    part ``sizes[c]`` long: padded to the longest for the all-gather,
    trimmed after."""
    top = max(sizes)
    if min(sizes) == top:
        return all_gather_cat(x, dim, group)
    whole = all_gather_cat(_narrow_pad(x, dim, top), dim, group)
    return torch.cat([whole.narrow(dim, c * top, n) for c, n in enumerate(sizes)], dim)


def _reduce_scatter_uneven(g: torch.Tensor, dim: int, group, sizes: list[int]) -> torch.Tensor:
    top = max(sizes)
    if min(sizes) == top:
        return _reduce_scatter(g, dim, group)
    parts = [_narrow_pad(p, dim, top) for p in g.split(sizes, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.narrow(dim, 0, sizes[dist.get_rank(group)])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad, sizes):
        ctx.dim, ctx.group, ctx.reduce_grad, ctx.sizes = dim, group, reduce_grad, sizes
        return all_gather_uneven(x, dim, group, sizes)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            part = _reduce_scatter_uneven(g, ctx.dim, ctx.group, ctx.sizes)
        else:
            rank = dist.get_rank(ctx.group)
            part = g.narrow(ctx.dim, sum(ctx.sizes[:rank]), ctx.sizes[rank]).contiguous()
        return part, None, None, None, None


def gather_rows(x: torch.Tensor, dim: int, group, reduce_grad: bool = False,
                sizes: list[int] | None = None) -> torch.Tensor:
    """:func:`gather_from_group` of parts that may differ in length along
    ``dim`` (``sizes``: every rank's, by default all-gathered first)."""
    if sizes is None:
        sizes = part_sizes(x.shape[dim], group, x.device)
    return _GatherRows.apply(x, dim, group, reduce_grad, list(sizes))


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int] | None:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, held, need, group):
        ctx.held, ctx.need, ctx.group = held, need, group
        rank = dist.get_rank(group)
        (lo, _), (a, b) = held[rank], need[rank]
        fmt = (torch.channels_last if x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last) and not x.is_contiguous()
            else torch.contiguous_format)
        ctx.fmt = fmt
        shape = list(x.shape)
        shape[2] = b - a
        out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt).zero_()
        own = _overlap(held[rank], need[rank])
        if own is not None:
            out[:, :, own[0] - a:own[1] - a] = x[:, :, own[0] - lo:own[1] - lo]
        sends, recvs = [], []
        for peer in range(len(held)):
            if peer == rank:
                continue
            give = _overlap(held[rank], need[peer])
            if give is not None:
                sends.append((x[:, :, give[0] - lo:give[1] - lo], peer))
            take = _overlap(held[peer], need[rank])
            if take is not None:
                recvs.append((out[:, :, take[0] - a:take[1] - a], peer))
        send_recv(sends, recvs, group)
        return out

    @staticmethod
    def backward(ctx, g):
        held, need, group = ctx.held, ctx.need, ctx.group
        rank = dist.get_rank(group)
        (lo, hi), (a, _) = held[rank], need[rank]
        shape = list(g.shape)
        shape[2] = hi - lo
        gx = torch.empty(shape, dtype=g.dtype, device=g.device, memory_format=ctx.fmt).zero_()
        own = _overlap(held[rank], need[rank])
        if own is not None:
            gx[:, :, own[0] - lo:own[1] - lo] += g[:, :, own[0] - a:own[1] - a]
        # The rows this rank took from a peer send their gradient back; the
        # rows it gave come back as gradients to add into its own.
        sends, recvs = [], []
        for peer in range(len(held)):
            if peer == rank:
                continue
            take = _overlap(held[peer], need[rank])
            if take is not None:
                sends.append((g[:, :, take[0] - a:take[1] - a], peer))
            give = _overlap(held[rank], need[peer])
            if give is not None:
                recvs.append((g.new_empty(g.shape[:2] + (give[1] - give[0],) + g.shape[3:]),
                              peer, give))
        send_recv(sends, [(buf, peer) for buf, peer, _ in recvs], group)
        for buf, _, (r0, r1) in recvs:
            gx[:, :, r0 - lo:r1 - lo] += buf
        return gx, None, None, None


def fetch_rows(x: torch.Tensor, held, need, group) -> torch.Tensor:
    """Global rows [a, b) = ``need[rank]`` of a map split over ``group`` along
    dim 2, rank c holding rows ``held[c]`` (``x``: this rank's), from
    whichever ranks hold them; rows outside the map are zeros. ``held`` and
    ``need`` list every rank's [lo, hi), so each rank knows what to send
    whom. x's memory format is kept; differentiable (the backward sends each
    row's gradient to the rank that holds it and adds it there)."""
    return _FetchRows.apply(x, tuple(map(tuple, held)), tuple(map(tuple, need)), group)


# 'batches' / 'bytes' -> host-staged point-to-point exchanges, 'collectives'
# / 'collective_bytes' -> all-gathers and all-reduces of CUDA tensors over
# gloo, since the last reset.
_STAGED: collections.Counter = collections.Counter()


def reset_staged_counts() -> None:
    _STAGED.clear()


def staged_counts() -> dict[str, int]:
    return dict(_STAGED)


def send_recv(sends, recvs, group) -> None:
    """One batch of point-to-point transfers within ``group``: ``sends``
    (tensor, peer) pairs and ``recvs`` (buffer, peer) pairs, peers by their
    rank in the group; each buffer is filled in place when the call
    returns. A gloo group given CUDA tensors sends host copies and copies
    what it receives back."""
    ops = sends + recvs
    if not ops:
        return
    peer = lambda r: dist.get_global_rank(group, r)  # noqa: E731
    if ops[0][0].is_cuda and dist.get_backend(group) == "gloo":
        _STAGED["batches"] += 1
        _STAGED["bytes"] += sum(t.numel() * t.element_size() for t, _ in ops)
        out = [(t.contiguous().cpu(), r) for t, r in sends]
        into = [(torch.empty(b.shape, dtype=b.dtype), b, r) for b, r in recvs]
    else:
        out = [(t.contiguous(), r) for t, r in sends]
        into = [(b if b.is_contiguous() else torch.empty(b.shape, dtype=b.dtype, device=b.device),
                 b, r) for b, r in recvs]
    reqs = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, t, peer(r), group) for t, r in out]
        + [dist.P2POp(dist.irecv, buf, peer(r), group) for buf, _, r in into])
    for req in reqs:
        req.wait()
    for buf, b, _ in into:
        if buf is not b:
            b.copy_(buf)


def _buckets(tensors: list[torch.Tensor], limit: int):
    bucket: list[torch.Tensor] = []
    numel = 0
    for t in tensors:
        if bucket and numel + t.numel() > limit:
            yield bucket
            bucket, numel = [], 0
        bucket.append(t)
        numel += t.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor], group,
                     bucket_numel: int = BUCKET_NUMEL) -> None:
    """Average ``tensors`` (fp32) over ``group`` in place, through flat
    buckets of at most ``bucket_numel`` elements (one all-reduce each; a
    larger tensor is a bucket of its own)."""
    size = _size(group)
    for bucket in _buckets(tensors, bucket_numel):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])


@torch.no_grad()
def reduce_metrics(metrics: dict, group, max_keys=()) -> dict:
    """Metrics (0-d tensors) averaged over ``group``, those in ``max_keys``
    (1-d: one value per microbatch) maximised elementwise and then
    averaged, as a single process averages its microbatches' maxima."""
    keys = [k for k in metrics if k not in max_keys]
    means = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(means, group=group)
    out = dict(zip(keys, means / _size(group)))
    for k in max_keys:
        if k in metrics:
            v = metrics[k].float().clone()
            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
            out[k] = v.mean()
    return out
