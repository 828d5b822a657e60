"""The (data, context, model) mesh over the ranks of the default process
group, and the rows of a batch that each rank takes (PyTorch port of
``parallel/mesh.py``); the latent DiT's (data, pipe, expert) mesh and its
ambient axes.

Rank i sits where device i sits in the JAX package's
``np.array(devices).reshape(data, context, model)``: the model axis is
innermost. The batch is sharded over ``data`` only, so the ranks of one
model group (and of one context group) see the same rows.

:func:`create_dit_mesh` is the JAX dry run's phase-5 mesh,
``np.array(devices).reshape(data, pipe, expert)`` with ``expert``
innermost; the batch is again sharded over ``data`` only, so the ranks of
one pipe group and of one expert group see the same rows. :func:`serving_rows`
places a bucketed serving batch on the (data, context, model) mesh.
:func:`use_axes`
makes a mesh's axes ambient for a block, the port's counterpart of ``with
jax.set_mesh(mesh):``; :func:`ambient` is the JAX package's
``ambient_mesh_has_axis`` (the DiT reads its ``pipeline_axis``, the Switch
FFN its ``expert_axis`` and the data axis).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
CONTEXT_AXIS = "context"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, CONTEXT_AXIS, MODEL_AXIS)
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
DIT_AXES = (DATA_AXIS, PIPE_AXIS, EXPERT_AXIS)


@dataclasses.dataclass(frozen=True)
class Replicate:
    """Placement of a tensor every rank of a mesh dimension holds whole
    (the port's own of ``torch.distributed.tensor``'s, which never reaches a
    kernel: a kernel takes plain local tensors)."""


@dataclasses.dataclass(frozen=True)
class Shard:
    """Placement of a tensor split evenly along ``dim``, one slice a rank."""

    dim: int


def create_mesh(data: int | None = None, model: int = 1, context: int = 1,
                ranks: int | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` of dims (data, context, model) over the first
    ``ranks`` ranks of the default process group (default: every rank);
    ``data`` defaults to ranks / (model * context). A mesh of fewer ranks
    than the world is the JAX trainer's subset mesh
    (``jax.devices()[: data * model]``): every rank of the world must call
    this (it makes the mesh's groups), and a rank left out has no
    coordinate (``get_coordinate()`` is None). The mesh's device type is
    'cuda' under NCCL and 'cpu' otherwise (a gloo group carries CUDA
    tensors too: two ranks on one card, which NCCL refuses)."""
    world = dist.get_world_size()
    ranks = world if ranks is None else ranks
    if not 0 < ranks <= world:
        raise ValueError(f"a mesh of {ranks} ranks in a world of {world}")
    if data is None:
        if ranks % (model * context):
            raise ValueError(f"{ranks} ranks do not split into model {model} x "
                             f"context {context}")
        data = ranks // (model * context)
    if data * context * model != ranks:
        raise ValueError(f"mesh {data}x{context}x{model} != {ranks} ranks")
    return _mesh((data, context, model), AXES)


def _mesh(dims: tuple, names: tuple) -> DeviceMesh:
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(math.prod(dims)).reshape(dims),
                      mesh_dim_names=names)


def create_dit_mesh(data: int | None = None, pipe: int = 1, expert: int = 1) -> DeviceMesh:
    """A ``DeviceMesh`` of dims (data, pipe, expert) over every rank of the
    default process group (``data`` defaults to world / (pipe * expert)):
    the JAX dry run's ``reshape(n // 4, 2, 2)`` at pipe = expert = 2."""
    world = dist.get_world_size()
    if data is None:
        if world % (pipe * expert):
            raise ValueError(f"world size {world} does not split into pipe {pipe} x "
                             f"expert {expert}")
        data = world // (pipe * expert)
    if data * pipe * expert != world:
        raise ValueError(f"mesh {data}x{pipe}x{expert} != {world} ranks")
    return _mesh((data, pipe, expert), DIT_AXES)


@dataclasses.dataclass(frozen=True)
class AxisState:
    """A mesh axis's group, this rank's coordinate on it and its size."""

    group: object
    rank: int
    size: int


def axis_state(mesh: DeviceMesh, axis: str) -> AxisState:
    return AxisState(mesh.get_group(axis), mesh.get_local_rank(axis), axis_size(mesh, axis))


_AMBIENT: dict[str, AxisState] = {}


def ambient(axis: str | None) -> AxisState | None:
    """The ambient group of mesh axis ``axis`` (:func:`use_axes`); None where
    no ambient mesh defines it, or where it has one rank."""
    return _AMBIENT.get(axis) if axis else None


@contextlib.contextmanager
def use_axes(mesh: DeviceMesh | None):
    """Make every axis of more than one rank of ``mesh`` ambient for the
    block (None: none; an enclosing block's other axes stay)."""
    global _AMBIENT
    saved = _AMBIENT
    if mesh is not None:
        _AMBIENT = {**saved, **{a: axis_state(mesh, a) for a in mesh.mesh_dim_names
                                if axis_size(mesh, a) > 1}}
    try:
        yield
    finally:
        _AMBIENT = saved


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_coordinate(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(DATA_AXIS)


def data_axis_size(batch_size: int, world: int, model: int = 1) -> int:
    """The data axis of a global batch over ``world`` ranks with ``model``
    ranks a model group: world / model where the batch splits over that
    many, else gcd(batch, world / model), the JAX trainer's subset mesh
    (it takes the first data x model devices "rather than crashing on small
    debug batches"; the trainer leaves the other ranks idle)."""
    if world % model:
        raise ValueError(f"world size {world} is not a multiple of mesh_model {model}")
    return math.gcd(batch_size, world // model)


def replicated(mesh: DeviceMesh) -> tuple:
    """The placement of a tensor every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def batch_rows(batch_size: int, index: int, size: int, accum_steps: int = 1) -> np.ndarray:
    """The rows of a global batch that data coordinate ``index`` of ``size``
    takes: the batch splits into ``accum_steps`` microbatches first and each
    microbatch is sharded over data (the JAX step's reshape, then its
    ``P('data')`` placement), so the rank's local microbatch i holds
    microbatch i's index-th block of rows."""
    if batch_size % (accum_steps * size):
        raise ValueError(f"batch {batch_size} does not split into {accum_steps} "
                         f"microbatches over {size} data ranks")
    micro = batch_size // accum_steps
    local = micro // size
    return np.concatenate([np.arange(i * micro + index * local, i * micro + (index + 1) * local)
                           for i in range(accum_steps)])


def shard_batch(mesh: DeviceMesh | None, batch, accum_steps: int = 1):
    """This rank's rows of a global batch (a tensor or a numpy array), in
    :func:`batch_rows`' order; the batch itself without a mesh."""
    if mesh is None:
        return batch
    rows = batch_rows(batch.shape[0], data_coordinate(mesh), axis_size(mesh, DATA_AXIS),
                      accum_steps)
    if isinstance(batch, torch.Tensor):
        return batch[torch.as_tensor(rows, device=batch.device)]
    return batch[rows]


def serving_rows(mesh: DeviceMesh, batch_size: int) -> np.ndarray | None:
    """The rows of a bucketed serving batch that this rank computes (the JAX
    engine's ``_batch_sharding``): its data coordinate's block
    (:func:`batch_rows`) when the bucketed size divides the data axis, else
    None: every rank computes the whole batch (model-parallel compute only,
    e.g. one request of a giant variant)."""
    data = axis_size(mesh, DATA_AXIS)
    if data > 1 and batch_size % data == 0:
        return batch_rows(batch_size, data_coordinate(mesh), data)
    return None
