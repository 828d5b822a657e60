"""Batching and host -> device prefetch (PyTorch port of
``data/pipeline.py``).

``batch_iterator`` stacks samples into [B, H, W, C] numpy batches, as the
JAX package's does. ``prefetch_to_device`` assembles the next batches on a
background thread into pinned host memory, and the consumer copies each to
the device without blocking, so generation and the copy overlap the step
before (the JAX ``input_pipeline``'s double buffering).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def batch_iterator(sample_iter: Iterator[np.ndarray], batch_size: int,
                   drop_last: bool = True) -> Iterator[np.ndarray]:
    """Assemble [B, H, W, C] float32 batches from single samples."""
    buf: list = []
    for sample in sample_iter:
        buf.append(sample)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf and not drop_last:
        yield np.stack(buf)


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


def prefetch_to_device(batch_iter: Iterator[np.ndarray], device, size: int = 2
                       ) -> Iterator[torch.Tensor]:
    """Tensors on ``device`` from numpy batches, ``size`` batches ahead. An
    error in the source is raised in the consumer, never taken for the end
    of the data. The thread stops when the consumer drops the iterator."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batch_iter:
                t = torch.from_numpy(np.ascontiguousarray(batch))
                if not put(t.pin_memory() if pin else t):
                    return
            put(_END)
        except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
            put(_Failure(e))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.error
            yield item.to(device, non_blocking=pin)
    finally:
        stop.set()
        thread.join(timeout=5)


def input_pipeline(source_iter: Iterator[np.ndarray], batch_size: int, device,
                   prefetch: int = 2, drop_last: bool = True) -> Iterator[torch.Tensor]:
    """samples -> batches -> device tensors, prefetched."""
    return prefetch_to_device(batch_iterator(source_iter, batch_size, drop_last),
                              device, size=prefetch)
