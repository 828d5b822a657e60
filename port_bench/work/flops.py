"""Pinned floating-point work per image: the denominators of ``mfu.*``.

``REFERENCE_TFLOPS_PER_IMAGE`` is a copy of the port's ``utils/flops.py``
table (itself the JAX package's): the reference PyTorch model's encode +
decode forward at batch 1, counted once with ``FlopCounterMode`` (2
operations a multiply-add). It is pinned here, so that an exact reduction
of the work inside the program (a fused resample, a folded FFN) does not
move the denominator, and a later change to the program cannot either.

Training counts 3 forwards (forward, and the backward's two products a
layer), and LPIPS: VGG16's 13 convolutions forward on both images and the
backward to the reconstruction's pixels (one more forward's products; the
VGG weights are frozen), counted from VGG16's shapes. Recomputation is not
counted.
"""

from __future__ import annotations

from ..reference import lpips as lpips_ref

# (variant, compression_ratio, latent_dim, resolution) -> TFLOPs per image.
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

PEAK_BF16 = 989e12


def forward_flops(family: str, f: int, d: int, resolution: int) -> float:
    return REFERENCE_TFLOPS_PER_IMAGE[(family, f, d, resolution)] * 1e12


def vgg16_flops(resolution: int) -> float:
    """One LPIPS trunk forward (13 3x3 convolutions, 2x2 pools between
    blocks) on one image."""
    total = 0.0
    widths = lpips_ref.conv_widths()
    r, i = resolution, 0
    for c in lpips_ref.VGG16:
        if c == "M":
            r //= 2
            continue
        cin, cout = widths[i]
        total += 2 * 9 * cin * cout * r * r
        i += 1
    return total


def train_flops(family: str, f: int, d: int, resolution: int, lpips: bool = True) -> float:
    """One stage-1 training image: 3 forwards, and LPIPS's 2 forwards and
    the backward to the reconstruction."""
    work = 3 * forward_flops(family, f, d, resolution)
    if lpips:
        work += 3 * vgg16_flops(resolution)
    return work
