"""max_memory_allocated over the served window (reset at its start), in GiB."""

from port_bench.core import readers


def read(rec):
    return readers.peak_gib(rec)
