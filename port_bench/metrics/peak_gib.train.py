"""max_memory_allocated over the training window (reset at its start), in GiB."""

from port_bench.core import readers


def read(rec):
    return readers.peak_gib(rec)
