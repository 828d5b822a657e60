"""Device ms per image of the model's decoder (CUDA events around the model's
decode call) in the traced window."""

from port_bench.core import readers


def read(rec):
    return readers.device_ms_per_image(rec, "decode_ms")
