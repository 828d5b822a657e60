"""The training step's share of the card's bf16 peak, in %: images per second
(the traced run's window without the profiler) times the pinned training
FLOPs an image."""

from port_bench.core import readers


def read(rec):
    return readers.mfu_train(rec)
