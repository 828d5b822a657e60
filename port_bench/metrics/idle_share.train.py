"""1 minus the union of device kernel, copy and set intervals over the traced
training window, in %."""

from port_bench.core import readers


def read(rec):
    return readers.idle_share(rec)
