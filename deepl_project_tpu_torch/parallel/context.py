"""Context parallelism's ambient group (the port's counterpart of
``jax.set_mesh`` around a model whose ``context_axis`` names a mesh axis),
and the rows of a batch each rank takes (``context_batch_sharding``).

Under :func:`context_parallel` every map's rows (H) are split over the
mesh's ``context`` group by GSPMD's rule for an uneven shard
(:func:`row_split`): with r = ceil(h / C), rank c of C holds rows
[min(c r, h), min((c + 1) r, h)) of a map of h global rows, so trailing
ranks may hold fewer rows, or none. The input images split evenly: a height
the context size does not divide is refused (the JAX package's
``device_put`` refusal). The model's modules read the ambient state
(:func:`current`) and do by hand what GSPMD does in the JAX package:

- every convolution with a spatial extent > 1 or a stride fetches the rows
  its outputs read from whichever ranks hold them (``parallel/halo.py``;
  ``ops/layers.py``, ``ops/resample.py``, ``losses/lpips.py``), and each
  map it makes is split by the same rule on its own global height;
- every GroupNorm sums its moments over the group and divides them by the
  global count (``ops/norms.py``);
- RoPE reads the rows of the global (H, W) table (``ops/rope.py``);
- attention runs the exact ring over the group on each rank's token chunk,
  equal or not (``parallel/ring_attention.py``);
- an int8 convolution fetches halo rows of its float input before it
  quantizes (``ops/quant.py``), and calibration takes each site's maximum
  over the group.

A map's global row count reaches the modules through the state: the model
enters ``encode``, ``decode`` or its forward with :meth:`ContextState.for_map`
of its input (its global height from one all-reduce of the local rows), and
every map within is the same fraction of that input in both axes, so
:meth:`ContextState.map_rows` reads a map's global rows from its width. A
module called on its own under :func:`context_parallel` all-reduces its
input's rows instead.

The training steps' terms that read whole images gather each image's rows
(:func:`whole_rows`): the VF teacher and the VF term (its resize to the
teacher's grid reads across rank boundaries), and the discriminator, in
the generator's loss and in its own update. Every context rank computes
those terms whole, the same value on each. The L1 and KL terms, LPIPS and
the self-perceptual distance weight each rank's row means by its share of
the global rows (:func:`row_mean`), so that their average over the group is
the global mean. Within the GAN step the fresh reconstruction for the
discriminator runs under the group too.

A model whose config leaves ``context_axis`` unset refuses to run under an
ambient group (its rows would be read as whole maps); a model with the field
set and no ambient group computes what it computes without the field, as in
the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

import torch.distributed as dist

from .collectives import gather_rows
from .mesh import CONTEXT_AXIS, AxisState, axis_size, shard_batch


def row_split(rows: int, size: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of ``size`` ranks over a map of ``rows`` global rows:
    GSPMD's layout of an uneven shard, r = ceil(rows / size) rows a rank,
    the trailing ranks short or empty."""
    r = -(-rows // size)
    return [(min(c * r, rows), min((c + 1) * r, rows)) for c in range(size)]


@dataclasses.dataclass(frozen=True)
class ContextState(AxisState):
    """The context group, this rank's coordinate on it and its size; and,
    inside a model's call, the global (height, width) of the map it entered
    with (:meth:`for_map`)."""

    height: int | None = None
    width: int | None = None

    def split(self, rows: int) -> list[tuple[int, int]]:
        """Every rank's [lo, hi) of a map of ``rows`` global rows."""
        return row_split(rows, self.size)

    def row_range(self, rows: int) -> tuple[int, int]:
        """This rank's [lo, hi) of a map of ``rows`` global rows."""
        return self.split(rows)[self.rank]

    def sum_rows(self, local_rows: int, device) -> int:
        """The global row count of a map of ``local_rows`` rows on this rank:
        one all-reduce over the group."""
        t = torch.tensor([local_rows], dtype=torch.int64, device=device)
        dist.all_reduce(t, group=self.group)
        return int(t.item())

    def map_rows(self, x: torch.Tensor) -> int:
        """The global row count of this rank's rows ``x`` [B, C, h, w] of a
        map (:meth:`rows_of`)."""
        return self.rows_of(x.shape[2], x.shape[3], x.device)

    def rows_of(self, local_rows: int, width: int, device) -> int:
        """The global row count of a map ``width`` wide of which this rank
        holds ``local_rows`` rows: ``height`` x ``width`` / the entered
        map's width inside a model's call, else from an all-reduce of the
        local rows."""
        if self.height is None:
            return self.sum_rows(local_rows, device)
        rows, rem = divmod(self.height * width, self.width)
        if rem:
            raise ValueError(f"a map {width} wide is no fraction of the "
                             f"{self.height}x{self.width} input under context parallelism")
        return rows

    def for_map(self, x: torch.Tensor) -> "ContextState":
        """This state with ``x``'s map (this rank's rows, [B, C, h, w]) as
        the one every later map is a fraction of: its global height from
        the group, checked against this rank's share of the split."""
        rows = self.sum_rows(x.shape[2], x.device)
        lo, hi = self.row_range(rows)
        if hi - lo != x.shape[2]:
            raise ValueError(f"rank {self.rank} of {self.size} holds {x.shape[2]} rows of a map "
                             f"of {rows}, where the row split gives it {hi - lo}: take the "
                             "rows with parallel.shard_rows / split_rows")
        return dataclasses.replace(self, height=rows, width=x.shape[3])


_STATE: ContextState | None = None


def current() -> ContextState | None:
    """The ambient context state, or None outside :func:`context_parallel`
    (or under a context axis of size 1)."""
    return _STATE


def context_axis_size() -> int:
    """The ambient context group's size, 1 without one (the JAX package's
    ``_ambient_axis_size``)."""
    return 1 if _STATE is None else _STATE.size


@contextlib.contextmanager
def use(state: ContextState | None):
    """Make ``state`` the ambient one for the block (None: none)."""
    global _STATE
    saved, _STATE = _STATE, state
    try:
        yield state
    finally:
        _STATE = saved


def state_of(mesh) -> ContextState | None:
    """The context state of ``mesh``'s ``context`` axis; None at size 1."""
    size = axis_size(mesh, CONTEXT_AXIS)
    if size == 1:
        return None
    return ContextState(mesh.get_group(CONTEXT_AXIS), mesh.get_local_rank(CONTEXT_AXIS), size)


@contextlib.contextmanager
def context_parallel(mesh):
    """Make ``mesh``'s context group ambient for the block: the counterpart
    of ``with jax.set_mesh(mesh):`` around a model with ``context_axis``."""
    with use(state_of(mesh)) as state:
        yield state


def call_in(state: ContextState | None, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``state`` ambient: a checkpointed block's
    recompute runs in the backward, outside the caller's block."""
    with use(state):
        return fn(*args, **kwargs)


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """Each image's whole rows of this rank's NCHW rows ``x`` (H on dim 2),
    gathered over the ambient context group (the ranks' shares equal or
    not); ``x`` itself without one. Every rank then computes the same
    whole-image term from them. The backward reduce-scatters, so this
    rank's rows receive C times their share of that term's gradient;
    averaged over the parameter peers (data x context) as the steps
    average, the term's gradient counts once, as the row means' do
    (:func:`row_mean`)."""
    state = current()
    if state is None:
        return x
    return gather_rows(x, 2, state.group, reduce_grad=True)


def row_mean(x: torch.Tensor, dims, rows: int | None = None) -> torch.Tensor:
    """``x.mean(dims)`` of this rank's rows ``x`` (H on dim 2, in ``dims``)
    under the ambient context group, weighted by this rank's share of the
    map's global rows: the sum over ``dims`` times C over the global count.
    The group's mean of it (the steps' average over the parameter peers, or
    ``collectives.global_mean``) is the whole map's mean, whatever the
    split, and a rank with no rows adds zero. ``rows``: the map's global
    rows (default: from the group). Without a group, ``x.mean(dims)``."""
    state = current()
    if state is None:
        return x.mean(dims)
    dims = tuple(d % x.dim() for d in dims)
    if 2 not in dims:
        raise ValueError("row_mean reduces over the rows (dim 2)")
    rows = state.map_rows(x) if rows is None else rows
    count = math.prod(x.shape[d] for d in dims if d != 2) * rows
    return x.sum(dims) * (state.size / count)


def split_rows(images, rank: int, size: int, dim: int = 1):
    """This rank's rows of ``images`` along ``dim`` by :func:`row_split`
    (an even split where ``size`` divides the rows)."""
    lo, hi = row_split(images.shape[dim], size)[rank]
    index = [slice(None)] * images.ndim
    index[dim] = slice(lo, hi)
    out = images[tuple(index)]
    return out.contiguous() if isinstance(out, torch.Tensor) else np.ascontiguousarray(out)


def shard_rows(mesh, images, accum_steps: int = 1, dim: int = 1):
    """This rank's rows of a global batch of images: its data rows
    (``shard_batch``, within each microbatch), then its rows of each image
    along ``dim`` (H of NHWC images; 2 for NCHW) over the context axis --
    the JAX package's ``context_batch_sharding``, P('data', 'context'),
    whose ``device_put`` refuses a height the context size does not divide.
    The batch itself without a mesh."""
    if mesh is None:
        return images
    local = shard_batch(mesh, images, accum_steps)
    state = state_of(mesh)
    if state is None:
        return local
    if images.shape[dim] % state.size:
        raise ValueError(f"{images.shape[dim]} rows do not split over a context axis of "
                         f"{state.size} ranks: use a height that is a multiple of {state.size}")
    return split_rows(local, state.rank, state.size, dim)
