"""Images drawn from the seed on the device.

Each image is a smooth random field (noise at 1/16 of the resolution,
upsampled bilinearly) with fine noise on top, at a contrast, brightness and
fine-noise level of its own, clamped to [0, 1]: rows differ in what they
ask of the model, so that a batch's mean loss moves when rows are left out.
The draws come from one ``torch.Generator`` on the device in a few large
calls, so the same seed gives the same images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_STREAM = 2


@torch.no_grad()
def images(seed: int, count: int, resolution: int, device, stream: int = _STREAM
           ) -> torch.Tensor:
    """[count, H, W, 3] float32 in [0, 1] on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) * 16 + stream)
    low = max(resolution // 16, 2)
    coarse = torch.randn(count, 3, low, low, generator=gen, device=device)
    fine = torch.randn(count, 3, resolution, resolution, generator=gen, device=device)
    knobs = torch.rand(count, 3, generator=gen, device=device)
    contrast = (0.05 + 0.45 * knobs[:, 0]).view(-1, 1, 1, 1)
    offset = (0.25 + 0.5 * knobs[:, 1]).view(-1, 1, 1, 1)
    grain = (0.15 * knobs[:, 2]).view(-1, 1, 1, 1)
    smooth = F.interpolate(coarse, size=(resolution, resolution), mode="bilinear",
                           align_corners=False)
    x = (offset + contrast * smooth + grain * fine).clamp_(0.0, 1.0)
    return x.permute(0, 2, 3, 1).contiguous()


def uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 255.0).to(torch.uint8)
