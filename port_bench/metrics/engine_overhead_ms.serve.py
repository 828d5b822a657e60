"""The served requests' median latency less the median device time of a group
(CUDA events around the engine's group computation), in ms: the time a
request spends in the engine's queue, dispatcher and fetch thread."""

from port_bench.core import readers


def read(rec):
    return readers.engine_overhead_ms(rec)
