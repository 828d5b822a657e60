"""PatchGAN discriminator for stage-2 adversarial training (PyTorch port of
``models/discriminator.py``), NCHW.

A 70x70 PatchGAN (pix2pix-style) with instance norm: images [B, 3, H, W] in
[0, 1] -> a map of patch logits [B, 1, H', W'] in fp32 (30 x 30 at 256px:
``num_layers`` stride-2 4x4 convs halve the map, then ``conv_pen`` and
``conv_out``, 4x4 with stride 1 and padding 1, each take one pixel off).
Convs compute in ``dtype`` (bf16) on fp32 parameters, cast at each use as
in the model; the instance norm's statistics are fp32. Parameter names are
the JAX module's (``conv0`` .. ``conv{L-1}``, ``norm{i}``, ``conv_pen``,
``norm_pen``, ``conv_out``; ``scale`` -> ``weight``), so
``utils.convert.disc_params_to_torch_state_dict`` maps a JAX tree onto it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """A conv in the input's dtype on cast parameters, its bias added after
    the product is rounded to that dtype (flax's ``nn.Conv`` order)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y if self.bias is None else y + self.bias.to(x.dtype).view(1, -1, 1, 1)




class InstanceNorm(nn.Module):
    """Per-(image, channel) normalization over the spatial dims: fp32
    statistics as E[x^2] - E[x]^2 (clamped at 0), an affine ``weight`` /
    ``bias``, the result in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32, *,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        m1 = x32.mean(dim=(2, 3), keepdim=True)
        m2 = x32.square().mean(dim=(2, 3), keepdim=True)
        var = (m2 - m1.square()).clamp(min=0.0)
        y = (x32 - m1) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float().view(1, -1, 1, 1) + self.bias.float().view(1, -1, 1, 1)
        return y.to(self.dtype)


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN: [B, 3, H, W] in [0, 1] -> fp32 patch logits."""

    def __init__(self, base_channels: int = 64, num_layers: int = 3,
                 dtype=torch.bfloat16, *, device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        # LeakyReLU's 0.2 rounded to the compute dtype, as JAX multiplies by
        # a weakly typed 0.2 (0.2001953125 in bf16).
        self.slope = float(torch.tensor(0.2, dtype=dtype, device="cpu"))
        kw = dict(kernel_size=4, padding=1, device=device, dtype=param_dtype)
        ch = base_channels
        self.conv0 = Conv2d(3, ch, stride=2, **kw)
        for i in range(1, num_layers):
            prev, ch = ch, min(base_channels * 2 ** i, 512)
            setattr(self, f"conv{i}", Conv2d(prev, ch, stride=2, bias=False, **kw))
            setattr(self, f"norm{i}", InstanceNorm(ch, dtype=dtype, device=device,
                                                   param_dtype=param_dtype))
        prev, ch = ch, min(base_channels * 2 ** num_layers, 512)
        self.conv_pen = Conv2d(prev, ch, stride=1, bias=False, **kw)
        self.norm_pen = InstanceNorm(ch, dtype=dtype, device=device, param_dtype=param_dtype)
        self.conv_out = Conv2d(ch, 1, stride=1, **kw)

    @property
    def min_input(self) -> int:
        """The smallest side that leaves a logit map: after the stride-2
        convs the map is H / 2^L, and conv_pen and conv_out take one pixel
        each; anything smaller gives an empty map, whose mean is NaN."""
        return 3 * 2 ** self.num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] < self.min_input or x.shape[3] < self.min_input:
            raise ValueError(
                f"PatchDiscriminator(num_layers={self.num_layers}) needs inputs >= "
                f"{self.min_input}px; got {x.shape[2]}x{x.shape[3]}. Use fewer layers "
                "for small images.")
        h = F.leaky_relu(self.conv0(x.to(self.dtype)), self.slope)
        for i in range(1, self.num_layers):
            h = getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h))
            h = F.leaky_relu(h, self.slope)
        h = F.leaky_relu(self.norm_pen(self.conv_pen(h)), self.slope)
        return self.conv_out(h).float()


@torch.no_grad()
def init_disc_weights(disc: PatchDiscriminator,
                      generator: torch.Generator | None = None) -> PatchDiscriminator:
    """The JAX module's initializers: conv kernels N(0, 0.02), zero conv
    biases, unit norm scales and zero norm biases."""
    for m in disc.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, InstanceNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return disc
