"""Int8 post-training quantization primitives (PyTorch port of
``ops/quant.py``), the serving path's int8 matmuls and convolutions.

Scheme, as in the JAX package: symmetric per-output-channel int8 weights
(scale = absmax / 127), symmetric per-tensor int8 activations with static
scales from a calibration pass, int32 accumulation, then dequantization in
fp32 (``acc * (act_scale * kernel_scale)``), the bias, and a cast to the
compute dtype. Rounding is half to even and clipping at +-127 on both sides.

The int8 products are ``torch._int_mm`` (cuBLASLt's int8 GEMM on CUDA; an
exact integer product on the CPU), where the JAX package has
``lax.dot_general``/``conv_general_dilated`` with an int32 result. PyTorch
has no int8 convolution on CUDA, so a convolution is an int8 im2col
(channels-last, zero padding, which is exact: 0 quantizes to 0) followed by
the GEMM, in chunks of images that bound the patch matrix. On CUDA an
int8 GEMM of M <= 16 rows gets zero rows up to 17 (exact), and one whose K
or N is not a multiple of 8 raises with the shape: the int8 path never
falls back to a float one.

Weights are stored as the GEMM reads them fastest: output channels first,
reduction axis last and contiguous (``[N, K]`` for a dense layer,
``[N, kh, kw, C]`` for a convolution, whose patches are ordered (dy, dx, c)).

Calibration: modules built with ``calibrate=True`` record the running
maximum of |x| at each quantization site (:func:`record_amax`, the
counterpart of ``sow_amax``) in their ``amax`` dict.

Under an ambient context group (``parallel.context``: each map is this
rank's rows, split by ``context.row_split`` on the map's own height, so a
rank may hold fewer rows than the halo, or none) a :class:`QConv2d` taller
than one row fetches the halo rows of its float input from the ranks that
hold them before it quantizes (exact: the quantization is elementwise and
0 quantizes to 0) and convolves with no padding along H;
:func:`record_amax` takes each site's maximum over the group (a rank with
no rows adds 0), so calibration returns what the whole images give.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import context as cp
from ..parallel.halo import exchange_rows

QMAX = 127.0
# torch._int_mm on CUDA takes only M > 16 rows.
_MIN_ROWS = 16
# Bytes of one chunk's int8 patch matrix in :func:`int_conv`.
_IM2COL_BYTES = 1 << 31


def quantize_weight(w: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int8 quantization of a float kernel along
    ``axis`` (the output channels): (w_q int8, scale fp32 [out]) with
    w ~= w_q * scale."""
    w = w.float()
    axis = axis % w.dim()
    red = [i for i in range(w.dim()) if i != axis]
    amax = w.abs().amax(dim=red, keepdim=True)
    scale = amax.clamp_min(1e-12) / QMAX
    wq = torch.round(w / scale).clamp_(-QMAX, QMAX).to(torch.int8)
    return wq, scale.reshape(w.shape[axis])


def quantize_act(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """Static-scale int8 quantization: round(x * (1 / act_scale)) in fp32,
    clipped to +-127."""
    inv = 1.0 / act_scale.float()
    return torch.round(x.float() * inv).clamp_(-QMAX, QMAX).to(torch.int8)


def int_mm(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """a [M, K] int8 times w [N, K] int8 transposed: [M, N] int32."""
    if a.is_cuda:
        (m, k), n = a.shape, w.shape[0]
        if k % 8 or n % 8:
            raise ValueError(
                f"int8 GEMM of M={m}, K={k}, N={n}: torch._int_mm on CUDA needs "
                f"K and N multiples of 8")
        if m <= _MIN_ROWS:  # zero rows up to the GEMM's minimum: exact
            acc = torch._int_mm(F.pad(a, (0, 0, 0, _MIN_ROWS + 1 - m)), w.t())[:m]
            return acc if out is None else out.copy_(acc)
    if out is None:
        return torch._int_mm(a, w.t())
    return torch._int_mm(a, w.t(), out=out)


def int_conv(xq: torch.Tensor, kq: torch.Tensor, row_padding: int | None = None
             ) -> torch.Tensor:
    """Stride-1 convolution of int8 NHWC ``xq`` [B, H, W, C] with ``kq``
    [N, kh, kw, C] (odd kh, kw), 'SAME' along W and ``row_padding`` zero
    rows above and below along H ('SAME', kh // 2, by default; 0 for rows
    that already carry their halo): int32 [B, H + 2 row_padding - kh + 1,
    W, N], as int8 im2col plus :func:`int_mm`, in chunks of images."""
    b, hi, w, c = xq.shape
    n, kh, kw, _ = kq.shape
    ph = kh // 2 if row_padding is None else row_padding
    pw = kw // 2
    h = hi + 2 * ph - kh + 1
    k = kh * kw * c
    acc = torch.empty(b * h * w, n, dtype=torch.int32, device=xq.device)
    per = max(1, _IM2COL_BYTES // (h * w * k))
    w2 = kq.reshape(n, k)
    for i in range(0, b, per):
        x = xq[i:i + per]
        if kh == kw == 1:
            cols = x.reshape(-1, c)
        else:
            xp = F.pad(x, (0, 0, pw, pw, ph, ph))
            sb, sh, sw, sc = xp.stride()
            cols = xp.as_strided((x.shape[0], h, w, kh, kw, c),
                                 (sb, sh, sw, sh, sw, sc)).reshape(-1, k)
        int_mm(cols, w2, out=acc[i * h * w:(i + x.shape[0]) * h * w])
    return acc.view(b, h, w, n)


def _dequant(acc, act_scale, kscale, bias, out_dtype):
    y = acc.float().mul_(act_scale.float() * kscale)
    if bias is not None:
        y = y.add_(bias)
    return y.to(out_dtype)


def qmatmul(x, kq, kscale, act_scale, bias=None, out_dtype=torch.bfloat16):
    """x [..., K] @ kq [N, K]^T in int8 (int32 accumulation), dequantized
    to ``out_dtype``."""
    xq = quantize_act(x, act_scale).reshape(-1, x.shape[-1])
    y = _dequant(int_mm(xq, kq), act_scale, kscale, bias, out_dtype)
    return y.view(*x.shape[:-1], kq.shape[0])


def qconv(x, kq, kscale, act_scale, bias=None, out_dtype=torch.bfloat16,
          row_padding: int | None = None):
    """NHWC int8 convolution (stride 1, 'SAME'; ``row_padding``: see
    :func:`int_conv`), dequantized to ``out_dtype``."""
    return _dequant(int_conv(quantize_act(x, act_scale), kq, row_padding), act_scale, kscale,
                    bias, out_dtype)


def _int8_buffers(module: nn.Module, kshape, out: int, bias: bool, device) -> None:
    module.register_buffer("kernel_q", torch.zeros(kshape, dtype=torch.int8, device=device))
    module.register_buffer("kernel_scale", torch.ones(out, device=device))
    module.register_buffer("act_scale", torch.ones((), device=device))
    module.register_buffer("bias", torch.zeros(out, device=device) if bias else None)


class QLinear(nn.Module):
    """Int8 dense layer (``QDense``): buffers ``kernel_q`` [out, in] int8,
    ``kernel_scale`` [out], ``act_scale`` [] and ``bias`` [out], fp32;
    the output in the input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, device=None):
        super().__init__()
        _int8_buffers(self, (out_features, in_features), out_features, bias, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qmatmul(x, self.kernel_q, self.kernel_scale, self.act_scale, self.bias,
                       out_dtype=x.dtype)


class QConv2d(nn.Module):
    """Int8 stride-1 'SAME' convolution of an NCHW map (``QConv``): buffers
    ``kernel_q`` [out, kh, kw, in] int8, ``kernel_scale`` [out],
    ``act_scale`` [] and ``bias`` [out], fp32; the output in the input's
    dtype, channels-last in memory. Under an ambient context group a kernel
    taller than one row first exchanges kh // 2 halo rows a side (module
    docstring)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *, device=None):
        super().__init__()
        _int8_buffers(self, (out_channels, kernel_size, kernel_size, in_channels),
                      out_channels, True, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        state, half, rows = cp.current(), self.kernel_q.shape[1] // 2, None
        local = x.shape[2]
        if state is not None and half:
            x, rows = exchange_rows(x, half, half, state.group, state.map_rows(x)), 0
        if not local:  # a rank past the end of an uneven split (serving: no graph)
            b, _, _, w = x.shape
            return x.new_zeros(b, 0, w, self.kernel_q.shape[0]).permute(0, 3, 1, 2)
        y = qconv(x.permute(0, 2, 3, 1), self.kernel_q, self.kernel_scale, self.act_scale,
                  self.bias, out_dtype=x.dtype, row_padding=rows)
        return y.permute(0, 3, 1, 2)


def record_amax(module: nn.Module, name: str, x: torch.Tensor) -> None:
    """Fold max|x| (fp32) into ``module.amax[name]``: the running maximum of
    a quantization site over the calibration batches (under an ambient
    context group, over every rank's rows)."""
    v = torch.cat([x.detach().float().abs().flatten(), x.new_zeros(1, dtype=torch.float32)]).max()
    state = cp.current()
    if state is not None:
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=state.group)
    old = module.amax.get(name)
    module.amax[name] = v if old is None else torch.maximum(old, v)
