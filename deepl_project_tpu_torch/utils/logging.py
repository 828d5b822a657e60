"""Observability (PyTorch port of ``utils/logging.py``): TensorBoard
scalars, the JSONL run record, step timing and profiler traces.

``MetricWriter`` writes TensorBoard event files with tensorboardX and does
nothing where that package is absent, as the JAX package's does. Under a
process group, ``MetricWriter`` (unless ``only_primary=False``) and
``RunHistory`` write on rank 0 only (the JAX package's
``process_index() == 0``).
``profiler_trace`` records ``torch.profiler`` (host, and the card where
there is one) into a Chrome trace that TensorBoard's profile plugin and
Perfetto read, where the JAX package records ``jax.profiler``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Mapping


def is_primary() -> bool:
    """Rank 0 of the default process group, or a process without one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricWriter:
    """Scalars and images to a TensorBoard log directory (tensorboardX); a
    no-op without a ``log_dir``, where tensorboardX is not installed, and
    with ``only_primary`` on every rank but 0."""

    def __init__(self, log_dir: str | None, only_primary: bool = True):
        self._writer = None
        if log_dir is None or (only_primary and not is_primary()):
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(log_dir)

    def scalars(self, step: int, metrics: Mapping[str, float], prefix: str = "train") -> None:
        if self._writer is None:
            return
        for name, value in metrics.items():
            self._writer.add_scalar(f"{prefix}/{name}", float(value), step)

    def image(self, step: int, tag: str, image) -> None:
        """One [H, W, C] image under ``tag``."""
        if self._writer is not None:
            self._writer.add_image(tag, image, step, dataformats="HWC")

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class RunHistory:
    """Append-only JSONL run record (<output_dir>/history.jsonl); a no-op
    on every rank but 0."""

    def __init__(self, path: str):
        self.path = path if is_primary() else None
        if self.path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, step: int, metrics: Mapping[str, float], kind: str = "train") -> None:
        if self.path is None:
            return
        row = {"step": int(step), "kind": kind, "ts": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


class StepTimer:
    """Images per second over a trailing window of steps, after a warmup (a
    stall such as a validation pass leaves the rate once it is out of the
    window)."""

    def __init__(self, warmup: int = 2, window: int = 50):
        self.warmup = warmup
        self._count = 0
        self._ticks: collections.deque = collections.deque(maxlen=window + 1)

    def tick(self, batch_size: int) -> None:
        self._count += 1
        if self._count >= self.warmup:
            self._ticks.append((time.perf_counter(), batch_size))

    @property
    def images_per_sec(self) -> float:
        if len(self._ticks) < 2:
            return 0.0
        dt = self._ticks[-1][0] - self._ticks[0][0]
        return sum(n for _, n in list(self._ticks)[1:]) / dt if dt > 0 else 0.0


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Record the block under ``torch.profiler`` (CPU, and CUDA where
    available) and write its Chrome trace (``*.pt.trace.json``) into
    ``log_dir`` when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
