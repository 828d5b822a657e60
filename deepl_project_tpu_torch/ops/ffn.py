"""Feed-forward networks (PyTorch port of ``ops/ffn.py``): the convolutional
FFN and a standard MLP, on NCHW maps.

ConvFFN expands the channels by mlp_ratio*4 with a Linear, GELU, runs a conv
branch *with residual* at the expanded width, then projects back.
conv_type='full' is 1x1 -> GELU -> 3x3 -> GELU -> 1x1 at mlp_ratio*dim width;
'depthwise' is one 3x3 depthwise conv.

``fold_output`` (on by default, as in the JAX module) is the exact
reassociation (y + z W2) Wout = y Wout + z (W2 Wout) + folded biases: conv_0
and the y Wout term read gelu(y) in one [hidden, ch + dim] product, and
conv_2 and proj_out collapse into one [ch, dim] product on the narrow branch
(12% fewer FLOPs at mlp_ratio 1, and no [N, hidden] z2 or residual
intermediates). Its rounding points are the JAX module's: yw = y [W0 | Wout]
rounded to the compute dtype, W_fold = W2 Wout rounded to it, b_fold =
b2 Wout + bout in fp32, out = yw[:, ch:] + z W_fold (fp32) + b_fold rounded
once. Off, the literal reference op order runs. The parameters are the
reference's either way.

``dropout`` acts on the FFN's output (StandardFFN: also after its GELU) in
a call with ``deterministic=False``, as in the JAX modules, through
``layers.dropout``: under tensor parallelism on the reduced output, every
rank of the model group drawing one mask (``dropout_group``).

``quant='int8'`` (full conv type) builds the int8 serving form of the folded
op order (``_int8_forward``): int8 buffers instead of parameters, from
``quantize.quantize_model`` or a JAX-quantized tree.

Under tensor parallelism (``model_group`` set by ``parallel.shard_params``)
``proj_in``, ``conv_0`` (``conv.0``) and ``conv_2`` (``conv.4``) hold this
rank's output channels and ``proj_out`` its input channels, and the
unfolded op order runs (``_tensor_forward``): the fold's [W0 | Wout] head
would read the whole y for W0 and this rank's slice for Wout. conv_0 reads
the gathered y, the 3x3 conv (replicated) the gathered z, and proj_out's
partial products are summed over the group before its bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (copy_to_group, gather_from_group, reduce_from_group,
                                    scatter_to_group)
from .layers import GELU, CachedOperands, Conv2d, Linear, dropout, matmul_f32
from .quant import QConv2d, QLinear, qmatmul, record_amax


class ConvFFN(CachedOperands, nn.Module):
    """Inverted-bottleneck FFN with spatial conv mixing."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, conv_type: str = "full",
                 *, fold_output: bool = True, dropout: float = 0.0,
                 quant: str | None = None, calibrate: bool = False, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        hidden = int(dim * mlp_ratio * 4)
        ch = int(dim * mlp_ratio)
        self.fold_output, self.calibrate, self.amax = fold_output, calibrate, {}
        self.dropout = dropout
        # Tensor parallelism (module docstring); the group whose ranks draw
        # one dropout mask (any placement's model group).
        self.model_group = self.dropout_group = None
        self.quant = quant if conv_type == "full" else None
        self.act = GELU()
        if self.quant == "int8":
            self.proj_in = QLinear(dim, hidden, device=device)
            # conv_1 under the float tree's name of the 3x3 conv.
            self.conv = nn.ModuleDict({"2": QConv2d(ch, ch, 3, device=device)})
            for name, shape, dtype in (
                    ("w_head_q", (ch + dim, hidden), torch.int8),
                    ("w_head_scale", (ch + dim,), torch.float32),
                    ("act_scale_y", (), torch.float32), ("b0", (ch,), torch.float32),
                    ("w_fold_q", (dim, ch), torch.int8),
                    ("w_fold_scale", (dim,), torch.float32),
                    ("act_scale_z2", (), torch.float32), ("b_fold", (dim,), torch.float32)):
                self.register_buffer(name, torch.zeros(shape, dtype=dtype, device=device))
            return
        kw = dict(device=device, dtype=param_dtype)
        self.proj_in = Linear(dim, hidden, **kw)
        if conv_type == "full":
            self.conv = nn.Sequential(
                Conv2d(hidden, ch, 1, **kw), GELU(),
                Conv2d(ch, ch, 3, padding=1, **kw), GELU(),
                Conv2d(ch, hidden, 1, **kw))
        elif conv_type == "depthwise":
            self.conv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden, **kw)
        else:
            raise ValueError(f"Unknown conv_type: {conv_type}")
        self.proj_out = Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if self.quant == "int8":
            return self._int8_forward(x)
        out = self._tensor_forward(x) if self.model_group is not None else self._local(x)
        if self.dropout > 0.0 and not deterministic:
            # On the whole (under tensor parallelism: reduced) [B, C, H, W]
            # output, one mask over the model group.
            out = dropout(out, self.dropout, self.dropout_group)
        return out

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN on one rank's whole weights: the folded or the literal op
        order."""
        full = isinstance(self.conv, nn.Sequential)
        xt = x.permute(0, 2, 3, 1)  # [B, H, W, C]
        if self.calibrate and full:
            record_amax(self, "amax_in", xt)
        y = self.act(self.proj_in(xt))  # [B, H, W, hidden]
        if full and self.fold_output:
            return self._fold_forward(y)
        y = y.permute(0, 3, 1, 2)  # NCHW view, channels-last in memory
        y = y + self.conv(y)  # residual around the conv branch
        return self.proj_out(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def _tensor_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The unfolded op order on this rank's channels (module docstring).
        A gather whose consumer holds split weights (conv_0) sums its
        gradient over the group; one with replicated consumers keeps this
        rank's slice."""
        group = self.model_group
        y = self.act(self.proj_in(copy_to_group(x.permute(0, 2, 3, 1), group)))
        y = y.permute(0, 3, 1, 2)  # [B, hidden / m, H, W]
        if isinstance(self.conv, nn.Sequential):
            conv0, conv1, conv2 = self.conv[0], self.conv[2], self.conv[4]
            z = self.act(conv0(gather_from_group(y, 1, group, reduce_grad=True)))
            z = self.act(conv1(gather_from_group(z, 1, group)))
            s = y + conv2(copy_to_group(z, group))
        else:  # depthwise, replicated: on the gathered y, then this rank's slice
            full = gather_from_group(y, 1, group)
            s = scatter_to_group(full + self.conv(full), 1, group)
        out = F.linear(s.permute(0, 2, 3, 1), self.proj_out.weight.to(x.dtype))
        out = reduce_from_group(out, group) + self.proj_out.bias.to(x.dtype)
        return out.permute(0, 3, 1, 2)

    def _fold_operands(self, dt: torch.dtype):
        """(W_head [hidden, ch + dim], W_fold [ch, dim]) in ``dt`` and b_fold
        [dim] in fp32, cached per weight version; recomputed under autograd."""
        conv0, conv2, out = self.conv[0], self.conv[4], self.proj_out

        def make():
            ch, hidden = conv0.weight.shape[:2]
            wout = out.weight.t().to(dt)  # [hidden, dim]
            w_head = torch.cat([conv0.weight.reshape(ch, hidden).t().to(dt), wout], 1)
            w2 = conv2.weight.reshape(hidden, ch).t().to(dt)  # [ch, hidden]
            w_fold = matmul_f32(w2, wout).to(dt)
            # A [1, ch] row: a vector @ matrix product squeezes its output
            # in place, which a checkpoint policy that keeps products forbids.
            b_fold = (conv2.bias[None] @ out.weight.t())[0].add(out.bias).float()
            return w_head, w_fold, b_fold

        params = (conv0.weight, conv2.weight, conv2.bias, out.weight, out.bias)
        return self._cached(("fold", dt), params, make, differentiable=True)

    def _fold_forward(self, y: torch.Tensor) -> torch.Tensor:
        b, h, w, hidden = y.shape
        dt = y.dtype
        conv0, conv1 = self.conv[0], self.conv[2]
        ch = conv0.out_channels
        w_head, w_fold, b_fold = self._fold_operands(dt)
        if self.calibrate:
            record_amax(self, "amax_y", y)
        y2 = y.reshape(-1, hidden)
        # fp32 accumulation rounded once to dt: one bf16 GEMM on CUDA.
        yw = y2 @ w_head if y2.is_cuda else matmul_f32(y2, w_head).to(dt)
        z = self.act(yw[:, :ch] + conv0.bias.to(dt))
        if self.calibrate:
            record_amax(self, "amax_z", z)
        z = self.act(conv1(z.view(b, h, w, ch).permute(0, 3, 1, 2)))
        if self.calibrate:
            record_amax(self, "amax_z2", z)
        z = z.permute(0, 2, 3, 1).reshape(-1, ch)
        # (yw_tail + z W_fold) + b_fold in fp32, summed into the product
        # (out of place under autograd: a checkpoint policy may keep the
        # product, which must then stay as it was made).
        out = matmul_f32(z, w_fold)
        if torch.is_grad_enabled():
            out = out + yw[:, ch:] + b_fold
        else:
            out = out.add_(yw[:, ch:]).add_(b_fold)
        return out.to(dt).view(b, h, w, out.shape[-1]).permute(0, 3, 1, 2)

    def _int8_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The folded op order in int8: [W0 | Wout] and W2 Wout quantized per
        output channel offline, static activation scales."""
        b, _, h, w = x.shape
        dt = x.dtype
        ch = self.b0.shape[0]
        y = self.act(self.proj_in(x.permute(0, 2, 3, 1)))
        yw = qmatmul(y, self.w_head_q, self.w_head_scale, self.act_scale_y, out_dtype=dt)
        yw = yw.reshape(-1, yw.shape[-1])
        z = self.act(yw[:, :ch] + self.b0.to(dt))
        z = self.act(self.conv["2"](z.view(b, h, w, ch).permute(0, 3, 1, 2)))
        out = qmatmul(z.permute(0, 2, 3, 1), self.w_fold_q, self.w_fold_scale,
                      self.act_scale_z2, out_dtype=torch.float32)
        out = out.view(-1, out.shape[-1]).add_(yw[:, ch:]).add_(self.b_fold)
        return out.to(dt).view(b, h, w, out.shape[-1]).permute(0, 3, 1, 2)


class StandardFFN(nn.Module):
    """Plain Linear-GELU-Linear FFN (ablation baseline)."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, *, dropout: float = 0.0,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        kw = dict(device=device, dtype=param_dtype)
        self.dropout = dropout
        self.dropout_group = None  # replicated under every placement
        self.fc1 = Linear(dim, hidden, **kw)
        self.act = GELU()
        self.fc2 = Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        drop = self.dropout > 0.0 and not deterministic
        y = self.act(self.fc1(x.permute(0, 2, 3, 1)))
        if drop:
            y = dropout(y, self.dropout, self.dropout_group)
        y = self.fc2(y)
        if drop:
            y = dropout(y, self.dropout, self.dropout_group)
        return y.permute(0, 3, 1, 2)
