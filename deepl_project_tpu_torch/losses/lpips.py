"""LPIPS perceptual distance with a VGG16 trunk (PyTorch port of
``losses/lpips.py``), NCHW.

lpips.LPIPS(net='vgg', spatial=False) semantics: input in [-1, 1] ->
ImageNet-style shift/scale -> VGG16 features at relu1_2 / relu2_2 / relu3_3 /
relu4_3 / relu5_3 -> channel-unit-normalize -> squared difference -> 1x1
non-negative linear head -> spatial mean -> sum over the five taps.

Parameters are a plain dict on the JAX package's ``.npz`` schema
(``conv/w{i}``, ``conv/b{i}``, ``lin/w{i}``) with the conv kernels in
PyTorch's OIHW layout (the file holds HWIO; :func:`load_lpips_params`
transposes). Without the pretrained file the loss runs on random-init
weights (:func:`init_lpips_params`), so training runs end to end; quality
parity needs the real weights (``WEIGHTS.md``).

Under an ambient context group (``parallel.context``; x and y are this
rank's rows of each image) the VGG convs fetch their halo rows
(``parallel.halo``), the 2x2 max-pools pair global rows (floor at an odd
height, as on one device; each pooled map split by its own height, so a
rank may hold few rows or none), and each image's distance is its local
spatial means weighted by the rank's share of the rows
(``context.row_mean``) averaged over the group
(``collectives.global_mean``: every rank holds the image's distance, and
its gradient reaches this rank's rows unscaled, as the step's gradient
average over the group expects).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import context as cp
from ..parallel.collectives import global_mean
from ..parallel.halo import conv2d_rows, pool2x2_rows
from ..utils.convert import lpips_params_from_jax

# VGG16 convolutional config: channel widths per conv layer, 'M' = 2x2 maxpool.
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512)
# Indices (into conv outputs, post-ReLU) of the 5 LPIPS taps.
_TAP_AFTER_CONV = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)

# lpips.ScalingLayer constants (input in [-1,1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# The converted weights (scripts/convert_lpips_weights.py writes this
# schema; WEIGHTS.md), kept beside the port's package.
DEFAULT_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "weights", "lpips_vgg.npz")


def _conv_widths():
    in_ch = 3
    for c in _VGG16_CFG:
        if c != "M":
            yield in_ch, c
            in_ch = c


def init_lpips_params(generator: torch.Generator | None = None,
                      device=None) -> dict:
    """Random-init LPIPS params with the structure of the converted
    pretrained weights: He-normal convs, zero biases, |normal| / C heads (the
    JAX ``init_lpips_params``' distributions, drawn from ``generator``)."""
    device = torch.device(device if device is not None else "cpu")
    gen_dev = generator.device if generator is not None else device
    params: dict = {"conv": {}, "lin": {}}
    for idx, (cin, c) in enumerate(_conv_widths()):
        w = torch.randn(c, cin, 3, 3, generator=generator, device=gen_dev)
        params["conv"][f"w{idx}"] = (w * math.sqrt(2.0 / (9 * cin))).to(device)
        params["conv"][f"b{idx}"] = torch.zeros(c, device=device)
    for i, c in enumerate(_TAP_CHANNELS):
        w = torch.randn(c, generator=generator, device=gen_dev).abs() / c
        params["lin"][f"w{i}"] = w.to(device)
    return params


def load_lpips_params(path: str = DEFAULT_WEIGHTS_PATH, device=None) -> dict | None:
    """Converted pretrained weights from the ``.npz``; None if absent."""
    if not os.path.exists(path):
        return None
    raw = np.load(path)
    tree: dict = {"conv": {}, "lin": {}}
    for k in raw.files:
        group, name = k.split("/")
        tree[group][name] = raw[k]
    params = lpips_params_from_jax(tree)
    return {g: {n: t.to(device) for n, t in leaves.items()} for g, leaves in params.items()}


def lpips_params_available(path: str = DEFAULT_WEIGHTS_PATH) -> bool:
    return os.path.exists(path)


def get_lpips_params(path: str = DEFAULT_WEIGHTS_PATH, device=None,
                     generator: torch.Generator | None = None) -> dict:
    p = load_lpips_params(path, device)
    return p if p is not None else init_lpips_params(generator, device)


def _vgg_features(params: dict, x: torch.Tensor, rows: int | None = None
                  ) -> list[torch.Tensor]:
    """The VGG16 trunk's five tap activations; x NCHW in [-1, 1]. Under an
    ambient context group ``x`` is this rank's rows of a map of ``rows``
    global rows (default: from the group): the convs fetch their halo rows
    and the 2x2 pools pair global rows (``parallel.halo``), each map split
    by its own height; tap i has rows >> i global rows."""
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    taps = []
    idx = 0
    state = cp.current()
    if state is not None and rows is None:
        rows = state.map_rows(x)
    for c in _VGG16_CFG:
        if c == "M":
            if state is None:
                h = F.max_pool2d(h, 2, 2)
            else:
                h, rows = pool2x2_rows(h, state, rows), rows // 2
            continue
        w, b = params["conv"][f"w{idx}"], params["conv"][f"b{idx}"]
        h = F.relu(F.conv2d(h, w, b, padding=1) if state is None
                   else conv2d_rows(h, w, b, 1, (1, 1), 1, state, rows))
        if idx in _TAP_AFTER_CONV:
            taps.append(h)
        idx += 1
    return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(x.square().sum(dim=1, keepdim=True)) + eps)


def lpips(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per image: x, y NCHW in [-1, 1] -> [B] (fp32). Under
    an ambient context group each tap's spatial mean is this rank's rows'
    weighted by its share (``context.row_mean``), averaged over the group."""
    state = cp.current()
    rows = None if state is None else state.map_rows(x)
    fx = _vgg_features(params, x.float(), rows)
    fy = _vgg_features(params, y.float(), rows)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (_unit_normalize(a) - _unit_normalize(b)).square()
        d = (d * params["lin"][f"w{i}"].view(1, -1, 1, 1)).sum(dim=1, keepdim=True)
        total = total + cp.row_mean(d, (1, 2, 3), None if rows is None else rows >> i)
    return total if state is None else global_mean(total, state.group)
