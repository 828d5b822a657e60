"""3x3 convolutions with a thin input or output channel count, as matrix
products (PyTorch port of ``ops/thin_conv.py``; equal to the convolution up
to the order of its sums).

Two forms, for the model's boundary convs (the encoder's stem 3 -> C, the
decoder's head C -> 3):

- thin input (im2col): the nine padded shifts of x concatenated on
  channels in (dy, dx, ci) order, then one [9 Ci, Co] product;
- thin output (tap-major): one [Ci, 9 Co] product giving every tap's
  contribution at every pixel, then nine shifted slice-adds.

Both round as the JAX functions do: operands in x's dtype, fp32
accumulation, the bias added in fp32, one cast to x's dtype.
``ThinConv3x3`` takes the first form for Ci <= 32, the second for
Co <= 16 and the native convolution otherwise.

Not wired into the model, as in the JAX package (its in-model A/B lost on
both sites). The parameters are a ``Conv2d``'s (``weight`` [Co, Ci, 3, 3],
``bias`` [Co]), so the converter's ``kernel`` rule maps a JAX
``ThinConv3x3`` onto it unchanged. Maps are NCHW, as in the rest of the
port; the output keeps x's memory format (NCHW or channels_last).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import matmul_f32

# The JAX package's thresholds: 9 Ci columns stay narrow for Ci <= 32; a
# native conv with Co > 16 outputs is already dense.
_THIN_IN_MAX = 32
_THIN_OUT_MAX = 16


def _nhwc_out(y: torch.Tensor, x: torch.Tensor, bias) -> torch.Tensor:
    """fp32 [B, H, W, Co] plus the fp32 bias, cast once to x's dtype, as an
    NCHW tensor in x's memory format."""
    if bias is not None:
        y = y + bias.float()
    out = y.to(x.dtype).permute(0, 3, 1, 2)
    if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
        return out
    return out.contiguous()


def thin_input_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None) -> torch.Tensor:
    """Stride-1, pad-1 3x3 conv as im2col for a small Ci.

    x: [B, Ci, H, W]; weight: [Co, Ci, 3, 3]; returns [B, Co, H, W] in
    x's dtype."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))  # [B, H+2, W+2, Ci]
    xim = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                    dim=-1)  # [B, H, W, 9 Ci], channel (dy * 3 + dx) * Ci + ci
    # Row (dy * 3 + dx) * Ci + ci of the [9 Ci, Co] weight is weight[:, ci, dy, dx].
    wim = weight.permute(2, 3, 1, 0).reshape(9 * ci, co).to(x.dtype)
    y = matmul_f32(xim.reshape(-1, 9 * ci), wim).reshape(b, h, w, co)
    return _nhwc_out(y, x, bias)


def thin_output_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None) -> torch.Tensor:
    """Stride-1, pad-1 3x3 conv as a tap-major product for a small Co.

    x: [B, Ci, H, W]; weight: [Co, Ci, 3, 3]; returns [B, Co, H, W] in
    x's dtype."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    # [Ci, 9 Co]: column (dy * 3 + dx) * Co + o is weight[o, :, dy, dx].
    wflat = weight.permute(1, 2, 3, 0).reshape(ci, 9 * co).to(x.dtype)
    z = matmul_f32(x.permute(0, 2, 3, 1).reshape(-1, ci), wflat).reshape(b, h, w, 9 * co)
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    # y[p, q, o] = sum over (dy, dx) of z[p + dy - 1, q + dx - 1, (dy * 3 + dx) * Co + o].
    y = sum(zp[:, dy:dy + h, dx:dx + w, (dy * 3 + dx) * co:(dy * 3 + dx + 1) * co]
            for dy in range(3) for dx in range(3))
    return _nhwc_out(y, x, bias)


class ThinConv3x3(nn.Conv2d):
    """A stride-1, pad-1 3x3 ``Conv2d`` that takes the im2col form where
    Ci <= 32, else the tap-major form where Co <= 16, else the native
    convolution: a conv output in x's dtype, then the bias added in x's
    dtype (the JAX module's two roundings). Computes in x's dtype."""

    def __init__(self, in_channels: int, out_channels: int, use_bias: bool = True, *,
                 device=None, param_dtype=torch.float32):
        super().__init__(in_channels, out_channels, 3, padding=1, bias=use_bias,
                         device=device, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_channels <= _THIN_IN_MAX:
            return thin_input_conv3x3(x, self.weight, self.bias)
        if self.out_channels <= _THIN_OUT_MAX:
            return thin_output_conv3x3(x, self.weight, self.bias)
        y = F.conv2d(x, self.weight.to(x.dtype), None, padding=1)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None, None]
