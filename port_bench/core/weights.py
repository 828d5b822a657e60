"""The weights both sides get, drawn from the seed on the device.

One state dict of the reference layout (``reference.model.param_spec``) and
one LPIPS weight dict, each made from a ``torch.Generator`` on the device in
a few large draws (one normal draw for all leaves, then a scale per leaf),
so that the same seed gives the same tensors, bit for bit, on the same kind
of device. The scales are the reference initializers' (Kaiming normal over
fan-out for convolutions, 0.02 for linear layers, cut at two standard
deviations), with three changes that make the comparison see more of the
model: biases are drawn (std 0.02) and norm scales are 1 + 0.05 N(0, 1)
instead of zeros and ones, so that a path that drops a bias or an affine
shows; and the mean head is drawn at unit fan-in variance instead of the
reference's 1e-4, so that the encoder's features reach the decoder at their
own scale in served reconstructions (the log-variance head keeps 1e-4, so
the posterior's std stays near 1 in training).
"""

from __future__ import annotations

import math

import torch

from ..reference import lpips as lpips_ref
from ..reference import model as ref

_BIAS_STD = 0.02
_NORM_STD = 0.05
_LINEAR_STD = 0.02


def _std(kind: str, shape: tuple) -> float:
    if kind == "conv":
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "mu_head":
        return math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
    if kind == "logvar_head":
        return math.sqrt(1e-4 / (shape[1] * shape[2] * shape[3]))
    if kind == "linear":
        return _LINEAR_STD
    if kind == "bias":
        return _BIAS_STD
    if kind == "norm":
        return _NORM_STD
    raise ValueError(kind)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    # manual_seed takes 64 bits: the seed (up to a little over 2**31) and a
    # stream index stay apart.
    return torch.Generator(device=device).manual_seed(int(seed) * 16 + stream)


@torch.no_grad()
def model_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The reference-layout state dict, float32, views of one buffer."""
    spec = ref.param_spec(cfg)
    total = sum(math.prod(s) for _, s, _ in spec)
    flat = torch.randn(total, generator=_generator(seed, 0, device), device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        std = _std(kind, shape)
        if kind == "linear":
            t.clamp_(-2.0, 2.0)
        t.mul_(std)
        if kind == "norm":
            t.add_(1.0)
        out[name] = t
    return out


@torch.no_grad()
def lpips_weights(seed: int, device) -> dict:
    """LPIPS weights (``reference.lpips``' schema): He-normal VGG16 kernels,
    biases 0.02 N(0, 1), heads |N(0, 1)| / C."""
    widths = lpips_ref.conv_widths()
    sizes = [co * ci * 9 for ci, co in widths] + [co for _, co in widths] + list(
        lpips_ref.TAP_CHANNELS)
    flat = torch.randn(sum(sizes), generator=_generator(seed, 1, device), device=device)
    params, at = {"conv": {}, "lin": {}}, 0
    for i, (ci, co) in enumerate(widths):
        params["conv"][f"w{i}"] = flat[at:at + co * ci * 9].view(co, ci, 3, 3).mul_(
            math.sqrt(2.0 / (9 * ci)))
        at += co * ci * 9
    for i, (_, co) in enumerate(widths):
        params["conv"][f"b{i}"] = flat[at:at + co].mul_(_BIAS_STD)
        at += co
    for i, c in enumerate(lpips_ref.TAP_CHANNELS):
        params["lin"][f"w{i}"] = flat[at:at + c].abs_().div_(c)
        at += c
    return params
