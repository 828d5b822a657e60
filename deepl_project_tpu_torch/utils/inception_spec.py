"""InceptionV3 architecture spec (a copy of the JAX package's
``utils/inception_spec.py``, which the port does not import): the layout of
``utils/inception.py``'s parameters.

Layout follows torchvision's inception_v3 naming (the network pytorch-fid
uses for the canonical FID/rFID numbers, the paper's Table 1 protocol).
Every conv is a BasicConv2d: Conv2d(bias=False) + BatchNorm(eps=0.001) +
ReLU; the converter folds BN into a conv bias (exact in eval mode), so each
layer here is conv + bias + ReLU.

Spec entry: name -> (in_ch, out_ch, (kh, kw), (sh, sw), (ph, pw)).
"""

from __future__ import annotations

BN_EPS = 1e-3
FEATURE_DIM = 2048
INPUT_SIZE = 299


def _c(in_ch, out_ch, k, s=1, p=0):
    k = (k, k) if isinstance(k, int) else k
    s = (s, s) if isinstance(s, int) else s
    p = (p, p) if isinstance(p, int) else p
    return (in_ch, out_ch, k, s, p)


def _inception_a(prefix: str, in_ch: int, pool_features: int) -> dict:
    return {
        f"{prefix}.branch1x1": _c(in_ch, 64, 1),
        f"{prefix}.branch5x5_1": _c(in_ch, 48, 1),
        f"{prefix}.branch5x5_2": _c(48, 64, 5, p=2),
        f"{prefix}.branch3x3dbl_1": _c(in_ch, 64, 1),
        f"{prefix}.branch3x3dbl_2": _c(64, 96, 3, p=1),
        f"{prefix}.branch3x3dbl_3": _c(96, 96, 3, p=1),
        f"{prefix}.branch_pool": _c(in_ch, pool_features, 1),
    }


def _inception_b(prefix: str, in_ch: int) -> dict:
    return {
        f"{prefix}.branch3x3": _c(in_ch, 384, 3, s=2),
        f"{prefix}.branch3x3dbl_1": _c(in_ch, 64, 1),
        f"{prefix}.branch3x3dbl_2": _c(64, 96, 3, p=1),
        f"{prefix}.branch3x3dbl_3": _c(96, 96, 3, s=2),
    }


def _inception_c(prefix: str, in_ch: int, c7: int) -> dict:
    return {
        f"{prefix}.branch1x1": _c(in_ch, 192, 1),
        f"{prefix}.branch7x7_1": _c(in_ch, c7, 1),
        f"{prefix}.branch7x7_2": _c(c7, c7, (1, 7), p=(0, 3)),
        f"{prefix}.branch7x7_3": _c(c7, 192, (7, 1), p=(3, 0)),
        f"{prefix}.branch7x7dbl_1": _c(in_ch, c7, 1),
        f"{prefix}.branch7x7dbl_2": _c(c7, c7, (7, 1), p=(3, 0)),
        f"{prefix}.branch7x7dbl_3": _c(c7, c7, (1, 7), p=(0, 3)),
        f"{prefix}.branch7x7dbl_4": _c(c7, c7, (7, 1), p=(3, 0)),
        f"{prefix}.branch7x7dbl_5": _c(c7, 192, (1, 7), p=(0, 3)),
        f"{prefix}.branch_pool": _c(in_ch, 192, 1),
    }


def _inception_d(prefix: str, in_ch: int) -> dict:
    return {
        f"{prefix}.branch3x3_1": _c(in_ch, 192, 1),
        f"{prefix}.branch3x3_2": _c(192, 320, 3, s=2),
        f"{prefix}.branch7x7x3_1": _c(in_ch, 192, 1),
        f"{prefix}.branch7x7x3_2": _c(192, 192, (1, 7), p=(0, 3)),
        f"{prefix}.branch7x7x3_3": _c(192, 192, (7, 1), p=(3, 0)),
        f"{prefix}.branch7x7x3_4": _c(192, 192, 3, s=2),
    }


def _inception_e(prefix: str, in_ch: int) -> dict:
    return {
        f"{prefix}.branch1x1": _c(in_ch, 320, 1),
        f"{prefix}.branch3x3_1": _c(in_ch, 384, 1),
        f"{prefix}.branch3x3_2a": _c(384, 384, (1, 3), p=(0, 1)),
        f"{prefix}.branch3x3_2b": _c(384, 384, (3, 1), p=(1, 0)),
        f"{prefix}.branch3x3dbl_1": _c(in_ch, 448, 1),
        f"{prefix}.branch3x3dbl_2": _c(448, 384, 3, p=1),
        f"{prefix}.branch3x3dbl_3a": _c(384, 384, (1, 3), p=(0, 1)),
        f"{prefix}.branch3x3dbl_3b": _c(384, 384, (3, 1), p=(1, 0)),
        f"{prefix}.branch_pool": _c(in_ch, 192, 1),
    }


def conv_specs() -> dict:
    """All BasicConv2d layers, keyed by torchvision name."""
    spec = {
        "Conv2d_1a_3x3": _c(3, 32, 3, s=2),
        "Conv2d_2a_3x3": _c(32, 32, 3),
        "Conv2d_2b_3x3": _c(32, 64, 3, p=1),
        "Conv2d_3b_1x1": _c(64, 80, 1),
        "Conv2d_4a_3x3": _c(80, 192, 3),
    }
    spec.update(_inception_a("Mixed_5b", 192, 32))
    spec.update(_inception_a("Mixed_5c", 256, 64))
    spec.update(_inception_a("Mixed_5d", 288, 64))
    spec.update(_inception_b("Mixed_6a", 288))
    spec.update(_inception_c("Mixed_6b", 768, 128))
    spec.update(_inception_c("Mixed_6c", 768, 160))
    spec.update(_inception_c("Mixed_6d", 768, 160))
    spec.update(_inception_c("Mixed_6e", 768, 192))
    spec.update(_inception_d("Mixed_7a", 768))
    spec.update(_inception_e("Mixed_7b", 1280))
    spec.update(_inception_e("Mixed_7c", 2048))
    return spec


# (block name, type) in forward order after the stem.
BLOCKS = (
    ("Mixed_5b", "A"), ("Mixed_5c", "A"), ("Mixed_5d", "A"),
    ("Mixed_6a", "B"),
    ("Mixed_6b", "C"), ("Mixed_6c", "C"), ("Mixed_6d", "C"),
    ("Mixed_6e", "C"),
    ("Mixed_7a", "D"),
    ("Mixed_7b", "E"), ("Mixed_7c", "E"),
)
