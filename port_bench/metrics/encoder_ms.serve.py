"""Device ms per image of the model's encoder (CUDA events around the model's
encode call) in the traced window."""

from port_bench.core import readers


def read(rec):
    return readers.device_ms_per_image(rec, "encode_ms")
