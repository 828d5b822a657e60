"""The (data, context, model) mesh over the ranks of the default process
group, and the rows of a batch that each rank takes (PyTorch port of
``parallel/mesh.py``).

Rank i sits where device i sits in the JAX package's
``np.array(devices).reshape(data, context, model)``: the model axis is
innermost. The batch is sharded over ``data`` only, so the ranks of one
model group (and of one context group) see the same rows.
"""

from __future__ import annotations

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


@dataclasses.dataclass(frozen=True)
class Replicate:
    """Placement of a tensor every rank of a mesh dimension holds whole
    (the port's own of ``torch.distributed.tensor``'s, which never reaches a
    kernel: a kernel takes plain local tensors)."""


@dataclasses.dataclass(frozen=True)
class Shard:
    """Placement of a tensor split evenly along ``dim``, one slice a rank."""

    dim: int


def create_mesh(data: int | None = None, model: int = 1, context: int = 1) -> DeviceMesh:
    """A ``DeviceMesh`` of dims (data, context, model) over every rank of the
    default process group; ``data`` defaults to world / (model * context).
    The mesh's device type is 'cuda' under NCCL and 'cpu' otherwise (a gloo
    group carries CUDA tensors too: two ranks on one card, which NCCL
    refuses)."""
    world = dist.get_world_size()
    if data is None:
        if world % (model * context):
            raise ValueError(f"world size {world} does not split into model {model} x "
                             f"context {context}")
        data = world // (model * context)
    if data * context * model != world:
        raise ValueError(f"mesh {data}x{context}x{model} != {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world).reshape(data, context, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_coordinate(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(DATA_AXIS)


def data_axis_size(batch_size: int, world: int, model: int = 1) -> int:
    """The data axis of a global batch over ``world`` ranks with ``model``
    ranks a model group: world / model. The JAX trainer drops to a subset
    mesh of gcd(batch, devices / model) devices when the batch does not
    divide; the port refuses instead, naming the divisor (a rank left out
    of every group would still have been started by torchrun)."""
    if world % model:
        raise ValueError(f"world size {world} is not a multiple of mesh_model {model}")
    data = world // model
    if batch_size % data:
        raise ValueError(
            f"the global batch {batch_size} does not split over the data axis of "
            f"{data} ranks (world {world} / mesh_model {model}): use a batch that is "
            f"a multiple of {data}, or launch {math.gcd(batch_size, data) * model} "
            f"ranks (the JAX trainer's subset mesh, gcd(batch, world / model) x model)")
    return data


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
