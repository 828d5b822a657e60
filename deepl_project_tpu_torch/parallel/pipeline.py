"""GPipe pipeline parallelism over a ``pipe`` group, and the latent DiT's
placement over a (data, pipe, expert) mesh (PyTorch port of
``parallel/pipeline.py``).

The JAX package shards the stacked block params over ``'pipe'`` and runs
the schedule inside one ``shard_map``: a ``lax.scan`` over M + P - 1 ticks
in which every stage runs its local blocks and ``ppermute`` rotates the
activations to the next stage; a masked ``psum`` replicates the last
stage's result over ``'pipe'``, and autodiff writes the backward. Here
each stage is a process and the schedule is written out both ways
(:class:`_Pipeline`, a ``torch.autograd.Function``):

- Stage s holds slices [s depth/P, (s + 1) depth/P) of the stacked block
  params (:func:`stage_range`, the counterpart of ``stage_sharding``'s
  P('pipe') on the leading axis; :meth:`PipelinePlacement.shard` keeps
  only those slices of the DiT's stacks, so a stage allocates only its
  own), and runs them in order in each tick (JAX's ``_stage_apply``).
- The batch splits into M contiguous microbatches (``x.reshape(m, b // m,
  ...)``; a data rank's rows: :func:`microbatch_rows`, its own rows in M
  where M divides them, else its part of JAX's microbatches of the global
  batch, of unequal sizes). At tick t stage s runs microbatch t - s with
  *that microbatch's* conditioning, and its output goes to stage s + 1 by
  ``collectives.send_recv`` (one batch of transfers a tick; a gloo group
  stages CUDA tensors through host memory). The bubble's work is skipped:
  a stage runs only the ticks that hold a microbatch, where JAX computes
  clipped drain ticks and zero carries whose results it never selects.
- Each microbatch's blocks run on detached inputs with autograd on, and the
  graph is kept for the backward (GPipe: all M microbatches' activations
  live until then). The last stage's outputs are made whole on every pipe
  rank by a broadcast, the masked ``psum``.

Where the trouble lies, and what the Function does about it:

- *Transfer order in the backward.* Every rank runs the reverse schedule
  (ticks M + P - 2 down to 0) inside one backward call and issues one
  ``send_recv`` a tick, so the gradient of microbatch k always leaves
  stage s + 1 at the tick stage s expects it, whatever order autograd's
  engine reaches other nodes in (the ring's backward,
  ``ring_attention.py``, is the precedent).
- *``cond`` is used by every stage.* Its gradient is the sum over the pipe
  ranks of each stage's blocks' share: the backward all-reduces that share
  (in fp32) over the group, as ``collectives.copy_to_group`` would around
  the blocks' use of ``cond`` alone. The caller's other uses of ``cond``
  (the DiT's final adaLN) stay outside the Function and count once a rank.
- *The output y.* Every pipe rank computes the same head and loss from y,
  so the gradient of y is the same on every rank; the last stage uses its
  own and no copy is summed (what ``gather_from_group``'s backward would do
  wrong here). The input x feeds stage 0 only: its gradient is broadcast
  from stage 0, so the layers before the pipeline get it on every rank.
- *Explicit parameter lists.* The training steps take gradients with
  ``torch.autograd.grad`` on named parameters: the stage's stacks are
  inputs of the Function, so the loss reaches them on the rank that owns
  them, and the Function returns their gradients summed over the
  microbatches.

The collectives inside the blocks (expert parallelism's, ``ops/moe.py``)
run in the local graphs, microbatch by microbatch in the schedule's order
on every rank of an expert group (the ranks of one stage).

:class:`PipelinePlacement` places the DiT on a ``create_dit_mesh`` mesh:
the stacked blocks' slices over ``pipe``, the Switch FFN's experts over
``expert`` (the experts' axis of each expert weight: 1 in a stack, 0 in an
unrolled block), everything else whole on every rank. Each gradient is
averaged over the ranks that hold its parameter (the non-block parameters
over every rank, a stage's dense block parameters over data x expert, the
experts over data: equal to the mean over data, since the other ranks of
each group hold the same gradient, and it keeps the copies bit-equal); the
global norm counts each parameter once; checkpoints gather whole tensors.
"""

from __future__ import annotations

import collections
import re
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from .collectives import (all_gather_cat, all_reduce_mean_, all_reduce_sum, reduce_metrics,
                          send_recv)
from .mesh import DATA_AXIS, EXPERT_AXIS, PIPE_AXIS, axis_size

BlockFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]

# 'forward' / 'backward' -> microbatches this stage ran since the last reset.
_RUNS: collections.Counter = collections.Counter()


def reset_run_counts() -> None:
    _RUNS.clear()


def run_counts() -> dict[str, int]:
    return dict(_RUNS)


def stage_range(depth: int, stage: int, num_stages: int) -> range:
    """The blocks stage ``stage`` of ``num_stages`` holds: [s depth/P, (s +
    1) depth/P)."""
    if depth % num_stages:
        raise ValueError(f"depth {depth} not divisible by pipeline stages {num_stages}")
    per = depth // num_stages
    return range(stage * per, (stage + 1) * per)


def _leaves(stacked) -> list[torch.Tensor]:
    """The tensors of the (nested dict or list) ``stacked`` that require
    grad."""
    return [t for t in torch.utils._pytree.tree_leaves(stacked)
            if isinstance(t, torch.Tensor) and t.requires_grad]


def _slices(stacked) -> list:
    """The per-block pytrees of ``stacked`` (one unbind a leaf)."""
    leaves, spec = torch.utils._pytree.tree_flatten(stacked)
    parts = [t.unbind(0) for t in leaves]
    return [torch.utils._pytree.tree_unflatten([p[j] for p in parts], spec)
            for j in range(len(parts[0]))]


def microbatch_rows(local_rows: int, num_microbatches: int,
                    rows: tuple[int, int] | None = None) -> list[int]:
    """The sizes of this rank's microbatches, in order, of a pipeline call
    on ``local_rows`` rows that are rows [first, first + local_rows) of a
    global batch of ``total`` (``rows`` = (first, total); default the whole
    batch). The JAX schedule splits the global batch into M contiguous
    microbatches, rows [i B/M, (i + 1) B/M), and GSPMD splits each over the
    data ranks. Where M divides the local rows each rank splits its own
    rows evenly (M microbatches a rank, the smallest bubble); else the
    microbatches are JAX's, each rank's part of them, and a part a rank
    holds no row of is left out (a rank may run fewer microbatches than
    another). Every block is row by row, so either split computes the
    same rows: only the ranks of one pipe group must agree, and they hold
    the same rows."""
    first, total = (0, local_rows) if rows is None else rows
    m = num_microbatches
    if total % m:
        raise ValueError(f"batch {total} not divisible by num_microbatches {m}")
    if local_rows % m == 0:
        return [local_rows // m] * m
    size = total // m
    sizes = [min(first + local_rows, (i + 1) * size) - max(first, i * size) for i in range(m)]
    return [n for n in sizes if n > 0]


class _Schedule:
    """One pipeline call's stacks, group and microbatch sizes."""

    def __init__(self, block_fn: BlockFn, stacked, group, sizes: list[int]):
        self.block_fn, self.stacked, self.group, self.sizes = block_fn, stacked, group, sizes
        self.m = len(sizes)
        self.size, self.stage = dist.get_world_size(group), dist.get_rank(group)

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def run(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        for params in _slices(self.stacked):
            x = self.block_fn(params, x, cond)
        return x

    def forward(self, x: torch.Tensor, cond: torch.Tensor, graphs: list | None):
        """The forward ticks; y (whole on every rank). With ``graphs``, each
        microbatch's (input leaf, cond leaf, output) is appended to it."""
        m, p, s = self.m, self.size, self.stage
        xs, cs = x.split(self.sizes), cond.split(self.sizes)
        cur, outs = None, []
        for t in range(m + p - 1):
            k, out = t - s, None
            if 0 <= k < m:
                inp = xs[k] if s == 0 else cur
                if graphs is None:
                    out = self.run(inp, cs[k])
                else:
                    with torch.enable_grad():
                        xi = inp.detach().requires_grad_(x.requires_grad or s > 0)
                        ci = cs[k].detach().requires_grad_(cond.requires_grad)
                        h = self.run(xi, ci)
                    graphs.append((xi, ci, h))
                    out = h.detach()
                _RUNS["forward"] += 1
                if s == p - 1:
                    outs.append(out)
            recvs = []
            if s > 0 and 0 <= t + 1 - s < m:
                cur = torch.empty((self.sizes[t + 1 - s], *x.shape[1:]), dtype=x.dtype,
                                  device=x.device)
                recvs = [(cur, s - 1)]
            send_recv([(out, s + 1)] if out is not None and s < p - 1 else [], recvs,
                      self.group)
        y = torch.cat(outs) if s == p - 1 else torch.empty_like(x)
        if p > 1:
            dist.broadcast(y, self.peer(p - 1), group=self.group)
        return y


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cond, sched, *params):
        ctx.graphs = []
        ctx.sched = sched
        ctx.x_meta = (x.shape, x.dtype)
        return sched.forward(x, cond, ctx.graphs)

    @staticmethod
    def backward(ctx, dy):
        sched, graphs = ctx.sched, ctx.graphs
        m, p, s = sched.m, sched.size, sched.stage
        params = _leaves(sched.stacked)
        need_x, need_c = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dys = dy.split(sched.sizes)
        dxs = [None] * m
        dconds = [None] * m
        dparams = [None] * len(params)
        cur = None
        for t in reversed(range(m + p - 1)):
            k, d_in = t - s, None
            if 0 <= k < m:
                xi, ci, h = graphs[k]
                graphs[k] = None
                lead = [v if v.requires_grad else None for v in (xi, ci)]
                wrt = [v for v in lead if v is not None] + params
                got = list(torch.autograd.grad(h, wrt, dys[k] if s == p - 1 else cur,
                                               allow_unused=True))
                d_in, dconds[k] = (None if v is None else got.pop(0) for v in lead)
                for i, g in enumerate(got):
                    if g is not None:
                        dparams[i] = g if dparams[i] is None else dparams[i] + g
                _RUNS["backward"] += 1
                if s == 0:
                    dxs[k] = d_in
            recvs = []
            if s < p - 1 and 0 <= t - 1 - s < m:
                cur = torch.empty((sched.sizes[t - 1 - s], *dy.shape[1:]), dtype=dy.dtype,
                                  device=dy.device)
                recvs = [(cur, s + 1)]
            send_recv([(d_in, s - 1)] if d_in is not None and s > 0 else [], recvs,
                      sched.group)
        ctx.graphs = None
        dx = dcond = None
        if need_x:
            shape, dtype = ctx.x_meta
            dx = torch.cat(dxs) if s == 0 else dy.new_empty(shape, dtype=dtype)
            if p > 1:
                dist.broadcast(dx, sched.peer(0), group=sched.group)
        if need_c:
            ref = next(g for g in dconds if g is not None)
            dcond = torch.cat([ref.new_zeros((n, *ref.shape[1:])) if g is None else g
                               for g, n in zip(dconds, sched.sizes)])
            dcond = dcond.float() if p == 1 else all_reduce_sum(dcond.float(), sched.group)
            dcond = dcond.to(ref.dtype)
        dparams = [torch.zeros_like(w) if g is None else g for g, w in zip(dparams, params)]
        return (dx, dcond, None, *dparams)


def pipeline_apply(block_fn: BlockFn, stacked, x: torch.Tensor, cond: torch.Tensor, *,
                   group, num_microbatches: int = 8,
                   rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Run a stack of identical blocks as a P-stage pipeline over ``group``
    (P its size, stage s this rank's place in it).

    ``block_fn(params_one_block, x [B', N, D], cond [B', D]) -> [B', N,
    D]``: one block. ``stacked``: this stage's part of the stack, a pytree
    (dict or list) of tensors whose leading axis holds its slices
    :func:`stage_range` (what ``PipelinePlacement.shard`` leaves a model,
    and what JAX's ``shard_map`` hands each stage). ``x`` [B, N, D] and
    ``cond`` [B, D] are the same on every rank of the group: the whole
    batch, or with ``rows`` = (first, total) rows [first, first + B) of a
    global batch of ``total`` (a data rank's); the global batch %
    num_microbatches == 0, and the microbatches are
    :func:`microbatch_rows`'. Returns [B, N, D], the same on every rank;
    differentiable in x, cond and the stage's stacks."""
    sizes = microbatch_rows(x.shape[0], num_microbatches, rows)
    sched = _Schedule(block_fn, stacked, group, sizes)
    params = _leaves(stacked)
    if not torch.is_grad_enabled() or not (x.requires_grad or cond.requires_grad or params):
        with torch.no_grad():
            return sched.forward(x, cond, None)
    return _Pipeline.apply(x, cond, sched, *params)


_STACKED = "blocks.block."
_UNROLLED = re.compile(r"^block(\d+)\.")


def _stage_param(name: str) -> bool:
    """Whether ``name`` is a block's parameter (stacked or unrolled)."""
    return name.startswith(_STACKED) or _UNROLLED.match(name) is not None


class PipelinePlacement:
    """The latent DiT on a (data, pipe, expert) mesh (``create_dit_mesh``):
    its groups, and each parameter's kind by name -- ``replicated`` (every
    rank holds it whole), ``stage`` (a block's dense parameter: the ranks of
    one pipe coordinate hold it, a stack its stage's slices) or ``expert``
    (an expert weight: this rank's slice along the experts' axis, over the
    expert group). :meth:`shard` places
    a model and fills the kinds; the optimizer and the steps read the
    rest (the interface of ``sharding.Placement``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.data_group = mesh.get_group(DATA_AXIS)
        self.pipe_group = mesh.get_group(PIPE_AXIS)
        self.expert_group = mesh.get_group(EXPERT_AXIS)
        self.data_size = axis_size(mesh, DATA_AXIS)
        self.pipe_size = axis_size(mesh, PIPE_AXIS)
        self.expert_size = axis_size(mesh, EXPERT_AXIS)
        self.data_rank = mesh.get_local_rank(DATA_AXIS)
        self.pipe_rank = mesh.get_local_rank(PIPE_AXIS)
        self.expert_rank = mesh.get_local_rank(EXPERT_AXIS)
        # The holders of a stage's dense block parameters: data x expert at
        # this pipe coordinate. Every rank makes every such group, in order.
        ranks = mesh.mesh.transpose(0, 1).reshape(self.pipe_size, -1)
        groups = [dist.new_group(r.tolist()) for r in ranks]
        self.stage_group = groups[self.pipe_rank]
        self.kinds: dict[str, str] = {}
        self.full_shapes: dict[str, tuple] = {}
        self.depth = None

    # -- placing a model --------------------------------------------------
    def stage_range(self, depth: int) -> range:
        return stage_range(depth, self.pipe_rank, self.pipe_size)

    def shard(self, model: nn.Module) -> nn.Module:
        """Place a ``models.dit.DiT`` (materialised or on the meta device)
        in place: a stacked model (``pipeline_axis`` or ``scan_blocks``)
        keeps this stage's slices of its stacks; each Switch FFN holds this
        rank's experts. Returns the model."""
        from ..ops.moe import SwitchFFN

        cfg = model.config
        self.depth = cfg.depth
        self.full_shapes.update({n: tuple(p.shape) for n, p in model.named_parameters()})
        if self.pipe_size > 1:
            if not cfg.stacked:
                raise ValueError("a pipeline placement needs the stacked layout: build the "
                                 "DiT with pipeline_axis (or scan_blocks)")
            model.blocks.hold_slices(self.stage_range(cfg.depth))
        if self.expert_size > 1:
            for m in model.modules():
                if isinstance(m, SwitchFFN):
                    m.hold_experts(self.expert_rank, self.expert_size,
                                   axis=1 if cfg.stacked else 0)
        for name, p in model.named_parameters():
            self.kinds[name] = ("expert" if ".experts." in name and self.expert_size > 1
                                else "stage" if _stage_param(name) else "replicated")
        return model

    def kind(self, name: str) -> str:
        return self.kinds.get(name, "replicated")

    # -- the optimizer's interface ----------------------------------------
    def dim(self, name: str) -> int | None:
        """The experts' axis of an expert weight this rank holds in part."""
        if self.kind(name) != "expert":
            return None
        return 1 if name.startswith(_STACKED) else 0

    def _staged(self, name: str) -> bool:
        """Whether ``name`` is a stack this rank holds a pipe stage's part of."""
        return self.pipe_size > 1 and name.startswith(_STACKED)

    @property
    def sharded(self) -> bool:
        return self.pipe_size > 1 or self.expert_size > 1

    def full_shape(self, name: str, local: torch.Tensor) -> tuple:
        return tuple(self.full_shapes.get(name, local.shape))

    def scatter(self, full: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's experts of a whole tensor along ``dim`` (``full``
        itself when None)."""
        if dim is None:
            return full
        n = full.shape[dim] // self.expert_size
        return full.narrow(dim, self.expert_rank * n, n).clone()

    @torch.no_grad()
    def gather(self, local: torch.Tensor, dim: int | None) -> torch.Tensor:
        return local if dim is None else all_gather_cat(local, dim, self.expert_group)

    def sum_sharded(self, value: torch.Tensor) -> torch.Tensor:
        """An all-reduce (sum) over the expert group (the split dimension's
        holders)."""
        return all_reduce_sum(value, self.expert_group)

    def norm(self, tensors: list[torch.Tensor], names: list[str]) -> torch.Tensor:
        """The global L2 norm, each parameter counted once: the experts'
        squares summed over the expert group, then the blocks' over the pipe
        group; the replicated ones as they are."""
        zero = tensors[0].new_zeros((), dtype=torch.float32)

        def sq(kind):
            ts = [t for t, n in zip(tensors, names) if self.kind(n) == kind]
            return torch.stack(torch._foreach_norm(ts)).float().square().sum() if ts else zero

        blocks = sq("stage")
        if self.expert_size > 1:
            blocks = blocks + all_reduce_sum(sq("expert"), self.expert_group)
        if self.pipe_size > 1:
            blocks = all_reduce_sum(blocks, self.pipe_group)
        return (sq("replicated") + blocks).sqrt()

    def any_peer(self, flag: torch.Tensor) -> bool:
        """Whether the 0-d bool ``flag`` holds on any rank (a stage that
        skipped a step alone would desynchronise the others)."""
        t = flag.float().reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t)

    def full_named(self, named: dict, dim_of=None) -> dict:
        """{name: whole tensor} of the whole model from this rank's (name,
        tensor) dict: the experts gathered over the expert group, then each
        stack's stage slices over the pipe group in stage order: whole
        stacks (collective over every rank)."""
        dim_of = dim_of or self.dim
        out = {}
        for name, t in named.items():
            t = self.gather(t.detach(), dim_of(name))
            out[name] = all_gather_cat(t, 0, self.pipe_group) if self._staged(name) else t
        return out

    def local_named(self, full: dict, names, dim_of=None) -> dict:
        """This rank's part of a whole {name: tensor} dict, for ``names``."""
        dim_of = dim_of or self.dim
        missing = [n for n in names if n not in full]
        if missing:
            raise RuntimeError(f"the state lacks this rank's parameters: {missing[:8]}")
        out = {}
        for n in names:
            t = full[n]
            if self._staged(n):
                mine = self.stage_range(t.shape[0])
                t = t[mine.start:mine.stop]
            out[n] = self.scatter(t, dim_of(n))
        return out

    @torch.no_grad()
    def full_state(self, named, prefix: str = "") -> dict:
        """{name: whole tensor} of (name, local tensor) pairs: a whole
        checkpoint (every rank must call it)."""
        return self.full_named(dict(named))

    @torch.no_grad()
    def load_full(self, named, full: dict, prefix: str = "") -> None:
        """Copy this rank's part of each whole tensor of ``full`` into the
        matching local tensor of ``named``."""
        named = dict(named)
        for n, t in self.local_named(full, list(named)).items():
            named[n].copy_(t)

    # -- the step's interface ---------------------------------------------
    def rows(self, local_rows: int) -> tuple[int, int]:
        """(first, total) of this rank's rows in the global batch: every
        data rank holds as many (``shard_batch`` splits the batch evenly,
        as JAX's P('data')), so the mean over the data ranks of each rank's
        mean is the global batch's, each rank weighed by its rows."""
        return self.data_rank * local_rows, local_rows * self.data_size

    @torch.no_grad()
    def average_grads(self, grads: list[torch.Tensor], names: list[str]) -> None:
        """Each gradient averaged, in place, over the ranks that hold its
        parameter."""
        for kind, group, size in (("replicated", None, dist.get_world_size()),
                                  ("stage", self.stage_group,
                                   self.data_size * self.expert_size),
                                  ("expert", self.data_group, self.data_size)):
            part = [g for g, n in zip(grads, names) if self.kind(n) == kind]
            if part and size > 1:
                all_reduce_mean_(part, group if group is not None else dist.group.WORLD)

    def reduce_metrics(self, metrics: dict) -> dict:
        """Metrics averaged over data (the pipe and expert ranks of one data
        coordinate hold the same ones)."""
        return metrics if self.data_size == 1 else reduce_metrics(metrics, self.data_group)
