"""The optimizer's step per optimizer step, host clock synced at both ends, in
ms: the median of the traced run's timed steps."""

from port_bench.core import readers


def read(rec):
    return readers.median_of(rec, "optim_ms")
