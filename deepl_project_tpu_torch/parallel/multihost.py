"""Process-group set-up under torchrun (PyTorch port of
``parallel/multihost.py``).

torchrun (``python -m torch.distributed.run``) starts one process per rank
and sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
:func:`initialize_multihost` reads them and joins the default process group:
NCCL on CUDA, gloo on the CPU, or the ``backend`` the caller names. A
process that torchrun did not start (no RANK in its environment) joins
nothing: :func:`under_torchrun` is False and the single-process path runs
unchanged.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, axis_size, data_coordinate


def under_torchrun() -> bool:
    """Whether a launcher set this process's rank (torchrun does)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_multihost(backend: str | None = None, device=None,
                         init_method: str | None = None, rank: int | None = None,
                         world_size: int | None = None, timeout_s: float = 600.0) -> dict:
    """Join the default process group and pick this process's device.

    Rank, world size and LOCAL_RANK come from torchrun's environment unless
    given (``init_method`` and ``rank`` / ``world_size``: a ``file://``
    store, as the tests and chip_smoke.py start ranks without torchrun).
    ``device``: 'cpu', or a CUDA device (default, and for a bare 'cuda',
    ``cuda:LOCAL_RANK``); as the single-process entry points do, it raises
    when CUDA is asked for and absent, before joining any group.
    ``backend``: default NCCL for a CUDA device and gloo for the CPU.
    Returns the JAX function's four keys and ``device``."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepl_project_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' (--device cpu) to run the plain "
                "PyTorch path over gloo")
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
            "local_device_count": local, "global_device_count": dist.get_world_size(),
            "device": device}


def host_shard_info(mesh=None) -> tuple[int, int]:
    """(shard index, number of shards) of this rank's data: its coordinate
    on the mesh's ``data`` axis and that axis's size (model-axis peers read
    the same rows); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return data_coordinate(mesh), axis_size(mesh, DATA_AXIS)
