"""Pinned reference-architecture FLOP counts (a copy of the JAX package's
``utils/flops.py``, which the port does not import): the denominator of a
throughput's utilization.

Measured once from the reference PyTorch model with
``torch.utils.flop_counter.FlopCounterMode`` over encode + decode forward at
batch 1 (``scripts/reference_flops.py`` re-derives them); 2 x MACs per
matmul or conv. Pinned, so that an exact FLOP reduction in this code (a
fused resample) does not move the denominator.
"""

from __future__ import annotations

# (variant, compression_ratio, latent_dim, resolution) -> TFLOPs per image,
# encode+decode forward. torch 2.13 FlopCounterMode, 2026-08-17.
REFERENCE_TFLOPS_PER_IMAGE: dict[tuple[str, int, int, int], float] = {
    ("tiny", 16, 32, 256): 0.6552,
    ("base", 16, 32, 256): 0.8279,
    ("large", 16, 32, 256): 2.0626,
    ("huge", 16, 32, 256): 4.2945,
    ("giant", 16, 32, 256): 7.4072,
    ("large", 8, 16, 256): 6.3365,
    ("large", 16, 32, 512): 10.4731,
    ("large", 16, 32, 1024): 77.4548,
}


def reference_flops_per_image(variant: str, f: int = 16, d: int = 32,
                              res: int = 256) -> float:
    """Reference forward FLOPs/image; raises KeyError for unpinned points
    (re-derive with scripts/reference_flops.py and extend the table)."""
    return REFERENCE_TFLOPS_PER_IMAGE[(variant, f, d, res)] * 1e12
