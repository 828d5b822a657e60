"""Context parallelism's ambient group (the port's counterpart of
``jax.set_mesh`` around a model whose ``context_axis`` names a mesh axis),
and the rows of a batch each rank takes (``context_batch_sharding``).

Under :func:`context_parallel` every image's rows (H) are split evenly over
the mesh's ``context`` group: rank c of C holds rows [c h, (c + 1) h) of
each map, h = H / C. The model's modules read the ambient state
(:func:`current`) and do by hand what GSPMD does in the JAX package:

- every convolution with a spatial extent > 1 exchanges halo rows with its
  neighbours (``parallel/halo.py``; ``ops/layers.py``, ``ops/resample.py``,
  ``losses/lpips.py``);
- every GroupNorm sums its moments over the group (``ops/norms.py``);
- RoPE reads the rows of the global (H, W) table (``ops/rope.py``);
- attention runs the exact ring over the group
  (``parallel/ring_attention.py``);
- an int8 convolution exchanges halo rows of its float input before it
  quantizes (``ops/quant.py``), and calibration takes each site's maximum
  over the group.

The training steps' terms that read whole images gather each image's rows
(:func:`whole_rows`): the VF teacher and the VF term (its resize to the
teacher's grid reads across rank boundaries), and the discriminator, in
the generator's loss and in its own update. Every context rank computes
those terms whole, the same value on each. The L1 and KL terms are means
over this rank's rows; LPIPS and the self-perceptual distance each image's
mean over its local rows, averaged over the group. Within the GAN step
the fresh reconstruction for the discriminator runs under the group too.

Every map in the model is the same fraction of its global map, so the
global row count and this rank's first row follow from the local row count
(:meth:`ContextState.rows`). A model whose config leaves ``context_axis``
unset refuses to run under an ambient group (its rows would be read as
whole maps); a model with the field set and no ambient group computes what
it computes without the field, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .collectives import gather_from_group
from .mesh import CONTEXT_AXIS, AxisState, axis_size, shard_batch


@dataclasses.dataclass(frozen=True)
class ContextState(AxisState):
    """The context group, this rank's coordinate on it and its size."""

    def rows(self, local_rows: int) -> tuple[int, int]:
        """(global row count, this rank's first row) of a map of
        ``local_rows`` rows a rank."""
        return local_rows * self.size, local_rows * self.rank


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
    gathered over the ambient context group; ``x`` itself without one.
    Every rank then computes the same whole-image term from them. The
    backward reduce-scatters, so this rank's rows receive C times their
    share of that term's gradient; averaged over the parameter peers (data
    x context) as the steps average, the term's gradient counts once, as
    the row-local means' do."""
    state = current()
    if state is None:
        return x
    return gather_from_group(x, 2, state.group, reduce_grad=True)


def split_rows(images, rank: int, size: int, dim: int = 1):
    """Rows [rank h, (rank + 1) h) of ``images`` along ``dim``, h the row
    count over ``size``; raises when ``size`` does not divide it."""
    rows = images.shape[dim]
    if rows % size:
        raise ValueError(f"{rows} rows do not split over a context axis of {size} ranks: "
                         f"use a height that is a multiple of {size}")
    h = rows // size
    index = [slice(None)] * images.ndim
    index[dim] = slice(rank * h, (rank + 1) * h)
    out = images[tuple(index)]
    return out.contiguous() if isinstance(out, torch.Tensor) else np.ascontiguousarray(out)


def shard_rows(mesh, images, accum_steps: int = 1, dim: int = 1):
    """This rank's rows of a global batch of images: its data rows
    (``shard_batch``, within each microbatch), then its rows of each image
    along ``dim`` (H of NHWC images; 2 for NCHW) over the context axis --
    the JAX package's ``context_batch_sharding``, P('data', 'context').
    The batch itself without a mesh."""
    if mesh is None:
        return images
    local = shard_batch(mesh, images, accum_steps)
    state = state_of(mesh)
    return local if state is None else split_rows(local, state.rank, state.size, dim)
