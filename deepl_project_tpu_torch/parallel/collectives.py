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
  GroupNorm moments), whose gradient is the sum of every rank's.

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
