"""Plain LPIPS (VGG16 trunk, ``lpips.LPIPS(net='vgg')``'s distance) in
float32, on weights the benchmark hands over.

Inputs in [-1, 1] are shifted and scaled as the reference's ScalingLayer
does, run through VGG16's 13 convolutions (ReLU, 2x2 max-pools), and at
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 the channel-unit-normalised
features of the two images are differenced, squared, weighted by the
non-negative 1x1 head and averaged over space; the five taps are summed.
The weights are a dict ``{'conv': {'w{i}', 'b{i}'}, 'lin': {'w{i}'}}``
(OIHW kernels). The published LPIPS weights are not in the repository, so
the benchmark draws them from the seed (``core.weights.lpips_weights``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
TAPS = (1, 3, 6, 9, 12)  # conv indices whose ReLU output is a tap
TAP_CHANNELS = (64, 128, 256, 512, 512)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def conv_widths():
    """(in, out) channels of VGG16's 13 convolutions."""
    cin, out = 3, []
    for c in VGG16:
        if c != "M":
            out.append((cin, c))
            cin = c
    return out


def features(params: dict, x: torch.Tensor, ops=None) -> list[torch.Tensor]:
    shift = torch.tensor(SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    taps, i = [], 0
    for c in VGG16:
        if c == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        w, b = params["conv"][f"w{i}"], params["conv"][f"b{i}"]
        if ops is not None and ops.low:
            h, w = ops._q(h), ops._q(w)
        h = F.relu(F.conv2d(h, w, b, padding=1))
        if ops is not None and ops.low:
            h = ops._q(h)
        if i in TAPS:
            taps.append(h)
        i += 1
    return taps


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.sqrt(t.square().sum(dim=1, keepdim=True)) + 1e-10)


def distance(params: dict, x: torch.Tensor, y: torch.Tensor, ops=None) -> torch.Tensor:
    """[B] distances of NCHW images in [-1, 1]."""
    fx, fy = features(params, x, ops), features(params, y, ops)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (_unit(a) - _unit(b)).square() * params["lin"][f"w{i}"].view(1, -1, 1, 1)
        total = total + d.sum(dim=1).mean(dim=(1, 2))
    return total
