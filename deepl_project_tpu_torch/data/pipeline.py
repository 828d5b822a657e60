"""Batching and host -> device prefetch (PyTorch port of
``data/pipeline.py``).

``batch_iterator`` stacks samples into [B, H, W, C] numpy batches, and
``(image, label)`` items into ``(images, int32 labels [B])``, as the JAX
package's does. ``prefetch_to_device`` assembles the next batches on a
background thread into pinned host memory, and the consumer copies each to
the device without blocking, so generation and the copy overlap the step
before (the JAX ``input_pipeline``'s double buffering).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .datasets import _pipelined_map


def row_filter(batch_size: int, accum_steps: int, index: int, size: int
               ) -> Callable[[int], bool]:
    """The predicate on a sample's 0-based position in a stream of global
    batches that keeps data coordinate ``index`` of ``size``'s rows
    (``parallel.batch_rows``: its block of each microbatch), in order: a
    source filtered by it yields that rank's batches of batch_size / size."""
    from ..parallel.mesh import batch_rows

    rows = set(batch_rows(batch_size, index, size, accum_steps).tolist())
    return lambda k: k % batch_size in rows


def batch_iterator(sample_iter: Iterator, batch_size: int, drop_last: bool = True,
                   num_workers: int = 0,
                   sample_fn: Callable[[Any], Any] | None = None) -> Iterator:
    """Assemble [B, H, W, C] float32 batches from single samples, or
    ``(images, labels)`` from ``(image, label)`` items. With ``sample_fn``
    each raw item is mapped through it first, in order, on ``num_workers``
    threads when > 0 (PIL's decode and resize release the GIL). The JAX
    package's ``ThreadPoolExecutor.map`` submits the whole source at once;
    this map keeps ``2 * num_workers`` items in flight, so an unbounded
    source also yields."""
    if num_workers > 0 and sample_fn is not None:
        mapped = _pipelined_map(sample_fn, sample_iter, num_workers)
    elif sample_fn is not None:
        mapped = map(sample_fn, sample_iter)
    else:
        mapped = sample_iter

    def assemble(items):
        if isinstance(items[0], tuple):
            return (np.stack([s[0] for s in items]),
                    np.asarray([s[1] for s in items], np.int32))
        return np.stack(items)

    buf: list = []
    for sample in mapped:
        buf.append(sample)
        if len(buf) == batch_size:
            yield assemble(buf)
            buf = []
    if buf and not drop_last:
        yield assemble(buf)


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


def prefetch_to_device(batch_iter: Iterator, device, size: int = 2) -> Iterator:
    """Tensors on ``device`` from numpy batches (an ``(images, labels)``
    batch gives a pair of tensors), ``size`` batches ahead. An error in the
    source is raised in the consumer, never taken for the end of the data.
    The thread stops when the consumer drops the iterator."""
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
                parts = batch if isinstance(batch, tuple) else (batch,)
                ts = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in parts)
                if pin:
                    ts = tuple(t.pin_memory() for t in ts)
                if not put(ts if isinstance(batch, tuple) else ts[0]):
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
            if isinstance(item, tuple):
                yield tuple(t.to(device, non_blocking=pin) for t in item)
            else:
                yield item.to(device, non_blocking=pin)
    finally:
        stop.set()
        thread.join(timeout=5)


def input_pipeline(source_iter: Iterator, batch_size: int, device,
                   prefetch: int = 2, drop_last: bool = True) -> Iterator:
    """samples -> batches -> device tensors, prefetched."""
    return prefetch_to_device(batch_iterator(source_iter, batch_size, drop_last),
                              device, size=prefetch)
