"""InceptionV3 pool3 features (PyTorch port of ``utils/inception.py``), the
backbone of rFID (the paper's Table 1 protocol), NCHW.

Parameters are a plain dict on the JAX package's ``.npz`` schema
(``<name>/w``, ``<name>/b``; ``scripts/convert_inception_weights.py``
writes it with BatchNorm folded into the conv biases, exact in eval mode),
the kernels in PyTorch's OIHW layout (the file holds HWIO;
:func:`params_from_numpy` transposes). So every layer is conv + bias +
ReLU. The converted file is not in the repository (``WEIGHTS.md``):
without it :func:`get_inception_params` gives seeded random weights of the
same structure, which keep the pipeline testable, not the numbers
meaningful. They are drawn from a ``torch.Generator``, not ``jax.random``:
a known deviation, so parity tests pass JAX's parameters in.

Preprocessing (pytorch-fid's): NCHW images in [0, 1] -> bilinear resize to
299 x 299 -> scaled to [-1, 1] -> features [B, 2048]. The network runs in
fp32 with TF32 off on the card (the JAX function's precision), so rFID
does not depend on the card's matmul mode.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .inception_spec import BLOCKS, FEATURE_DIM, INPUT_SIZE, conv_specs

# The converted weights, kept beside the port's package as the LPIPS
# weights are. Read at call time, so a test can point it elsewhere.
DEFAULT_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "weights", "inception_v3.npz")

_SPECS = conv_specs()


def init_inception_params(generator: torch.Generator | None = None, device=None) -> dict:
    """Random params with the converted weights' structure: He-normal convs
    (layers in sorted name order, each drawn from ``generator``, default
    one seeded with 0 on ``device``), zero biases."""
    device = torch.device(device if device is not None else "cpu")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    gen_dev = generator.device
    params = {}
    for name, (cin, cout, (kh, kw), _, _) in sorted(_SPECS.items()):
        w = torch.randn(cout, cin, kh, kw, generator=generator, device=gen_dev)
        params[f"{name}/w"] = (w * math.sqrt(2.0 / (kh * kw * cin))).to(device)
        params[f"{name}/b"] = torch.zeros(cout, device=device)
    return params


def params_from_numpy(raw, device=None) -> dict:
    """fp32 tensors on ``device`` from the ``.npz`` schema (HWIO kernels ->
    OIHW); ``raw`` maps names to arrays (an ``np.load`` of the file, or
    the JAX package's params)."""
    out = {}
    for k in raw:
        a = torch.from_numpy(np.array(raw[k], np.float32))
        out[k] = (a.permute(3, 2, 0, 1) if k.endswith("/w") else a).contiguous().to(device)
    return out


def _path(path: str | None) -> str:
    return DEFAULT_WEIGHTS_PATH if path is None else path


def load_inception_params(path: str | None = None, device=None) -> dict | None:
    """The converted weights on ``device``; None where the file is absent."""
    path = _path(path)
    if not os.path.exists(path):
        return None
    with np.load(path) as raw:
        return params_from_numpy({k: raw[k] for k in raw.files}, device)


def inception_params_available(path: str | None = None) -> bool:
    return os.path.exists(_path(path))


def get_inception_params(path: str | None = None, device=None,
                         generator: torch.Generator | None = None) -> dict:
    p = load_inception_params(path, device)
    return p if p is not None else init_inception_params(generator, device)


# -- forward ---------------------------------------------------------------

def _conv(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    _, _, _, stride, padding = _SPECS[name]
    return F.relu(F.conv2d(x, params[f"{name}/w"], params[f"{name}/b"], stride, padding))


def _max_pool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avg_pool3s1p1(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


def _chain(params, p, x, names):
    for s in names:
        x = _conv(params, f"{p}.{s}", x)
    return x


def _block_a(params, p, x, pool_pad):
    b1 = _conv(params, f"{p}.branch1x1", x)
    b5 = _chain(params, p, x, ("branch5x5_1", "branch5x5_2"))
    b3 = _chain(params, p, x, ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"))
    bp = _conv(params, f"{p}.branch_pool", _avg_pool3s1p1(x, pool_pad))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(params, p, x, pool_pad):
    b3 = _conv(params, f"{p}.branch3x3", x)
    bd = _chain(params, p, x, ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"))
    return torch.cat([b3, bd, _max_pool3s2(x)], dim=1)


def _block_c(params, p, x, pool_pad):
    b1 = _conv(params, f"{p}.branch1x1", x)
    b7 = _chain(params, p, x, ("branch7x7_1", "branch7x7_2", "branch7x7_3"))
    bd = _chain(params, p, x, ("branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                               "branch7x7dbl_4", "branch7x7dbl_5"))
    bp = _conv(params, f"{p}.branch_pool", _avg_pool3s1p1(x, pool_pad))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(params, p, x, pool_pad):
    b3 = _chain(params, p, x, ("branch3x3_1", "branch3x3_2"))
    b7 = _chain(params, p, x, ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                               "branch7x7x3_4"))
    return torch.cat([b3, b7, _max_pool3s2(x)], dim=1)


def _block_e(params, p, x, pool_pad):
    b1 = _conv(params, f"{p}.branch1x1", x)
    h = _conv(params, f"{p}.branch3x3_1", x)
    b3 = torch.cat([_conv(params, f"{p}.branch3x3_2a", h),
                    _conv(params, f"{p}.branch3x3_2b", h)], dim=1)
    h = _chain(params, p, x, ("branch3x3dbl_1", "branch3x3dbl_2"))
    bd = torch.cat([_conv(params, f"{p}.branch3x3dbl_3a", h),
                    _conv(params, f"{p}.branch3x3dbl_3b", h)], dim=1)
    bp = _conv(params, f"{p}.branch_pool", _avg_pool3s1p1(x, pool_pad))
    return torch.cat([b1, b3, bd, bp], dim=1)


_BLOCK_FNS = {"A": _block_a, "B": _block_b, "C": _block_c, "D": _block_d, "E": _block_e}


@torch.inference_mode()
def inception_features(params: dict, x: torch.Tensor, resize: bool = True,
                       count_include_pad: bool = False) -> torch.Tensor:
    """pool3 features [B, 2048] of NCHW images in [0, 1], in fp32.

    ``count_include_pad=False`` matches pytorch-fid's FID-variant average
    pools; True matches stock torchvision. The resize is
    ``jax.image.resize``'s bilinear (``F.interpolate`` with antialias)."""
    x = x.float()
    if resize and tuple(x.shape[2:]) != (INPUT_SIZE, INPUT_SIZE):
        x = F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                          antialias=True, align_corners=False)
    x = x * 2.0 - 1.0
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        h = x
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            h = _conv(params, name, h)
        h = _max_pool3s2(h)
        for name in ("Conv2d_3b_1x1", "Conv2d_4a_3x3"):
            h = _conv(params, name, h)
        h = _max_pool3s2(h)
        for name, kind in BLOCKS:
            h = _BLOCK_FNS[kind](params, name, h, count_include_pad)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    feats = h.mean(dim=(2, 3))  # global average pool
    if feats.shape[-1] != FEATURE_DIM:
        raise ValueError(f"features of width {feats.shape[-1]}, want {FEATURE_DIM}")
    return feats


def make_inception_feature_fn(params: dict | None = None, device=None):
    """Feature fn (NCHW [0, 1] images -> [B, 2048]) for ``utils.fid.rfid`` and
    ``evaluation``: ``params`` default to :func:`get_inception_params` on
    ``device``."""
    params = params if params is not None else get_inception_params(device=device)
    return lambda x: inception_features(params, x)
