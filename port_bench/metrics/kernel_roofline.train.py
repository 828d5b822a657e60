"""The hand-written kernels' share of their roofline, in %, over the trained
traced window."""

from port_bench.core import readers


def read(rec):
    return readers.roofline(rec)
