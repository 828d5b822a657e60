"""Global self-attention over feature maps, with QKV-norm and 2D RoPE
(PyTorch port of ``ops/attention.py``).

Three separate LayerNorms on the block input, bias-free Q/K/V linears, heads
of ``head_dim``, 2D RoPE on Q and K, softmax at scale head_dim**-0.5, and an
output projection with bias.

Dispatch (``impl='auto'``), as in the JAX module:

- N <= 1024 and the kernels' limits hold: the whole sublayer runs as
  ``fused_attention_sublayer`` (three Hopper kernels);
- N > 1024 within the kernels' limits (stage 2 at 256px, N=4096): the
  ``ln_qkv_rope`` kernel, then the plain query-chunked core below, then the
  projection as a plain matmul -- the JAX package also leaves both to XLA;
- otherwise (other head widths, float32): the composable plain path.

``impl='xla'`` forces the composable plain path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .hopper.fused_attention_block import (fused_attention_sublayer,
                                           kernel_supported, ln_qkv_rope,
                                           pack_qkv, sublayer_supported)
from .layers import Linear
from .norms import LayerNorm
from .rope import apply_rope2d

# Query rows per chunk of the plain core: bounds the fp32 logits to
# [B*h, chunk, N] (at b32, stage 2: 3.2 GB instead of 12.9 GB unchunked).
_CHUNK = 1024


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with fp32 accumulation and an fp32 result."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def xla_attention(q, k, v, scale: float) -> torch.Tensor:
    """Plain attention core: [B, N, nh, hd] x3 -> [B, N, nh, hd]. fp32 logits
    and softmax, weights rounded to v's dtype for P.V (fp32 accumulation),
    query-chunked (the math of ``xla_attention``/``xla_attention_chunked``)."""
    b, n, h, d = q.shape
    # A power-of-two scale (head_dim 64: 1/8) is exact on q, which saves a
    # pass over the fp32 logits; any other scale multiplies the logits.
    exact = math.frexp(scale)[0] == 0.5
    if exact:
        q = q * scale
    qh, kh, vh = (t.permute(0, 2, 1, 3).reshape(b * h, n, d) for t in (q, k, v))
    kt = kh.transpose(1, 2)
    out = torch.empty_like(qh)
    for r0 in range(0, n, _CHUNK):
        logits = _bmm_f32(qh[:, r0:r0 + _CHUNK], kt)
        weights = torch.softmax(logits if exact else logits.mul_(scale),
                                dim=-1).to(v.dtype)
        del logits
        if weights.dtype == torch.float32:
            out[:, r0:r0 + _CHUNK] = torch.bmm(weights, vh)
        else:
            out[:, r0:r0 + _CHUNK] = _bmm_f32(weights, vh).to(v.dtype)
    return out.reshape(b, h, n, d).permute(0, 2, 1, 3)


class AttentionRoPE(nn.Module):
    """Multi-head global attention on an NCHW feature map."""

    def __init__(self, dim: int, head_dim: int = 64, use_rope: bool = True,
                 rope_pairing: str = "reference", impl: str = "auto", *,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        if impl not in ("auto", "xla"):
            raise NotImplementedError(f"attention impl {impl!r} is not yet ported")
        self.dim, self.head_dim = dim, head_dim
        self.use_rope, self.rope_pairing, self.impl = use_rope, rope_pairing, impl
        kw = dict(device=device, dtype=param_dtype)
        self.norm_q = LayerNorm(dim, **kw)
        self.norm_k = LayerNorm(dim, **kw)
        self.norm_v = LayerNorm(dim, **kw)
        self.to_q = Linear(dim, dim, bias=False, **kw)
        self.to_k = Linear(dim, dim, bias=False, **kw)
        self.to_v = Linear(dim, dim, bias=False, **kw)
        self.proj = Linear(dim, dim, bias=True, **kw)
        self._packed, self._packed_key = None, None

    def _qkv_args(self):
        ln = tuple((m.weight, m.bias) for m in (self.norm_q, self.norm_k, self.norm_v))
        return ln, self.to_q.weight, self.to_k.weight, self.to_v.weight

    def _packed_qkv(self):
        """pack_qkv of the current weights, rebuilt when any of them changes."""
        ln, wq, wk, wv = self._qkv_args()
        params = [t for pair in ln for t in pair] + [wq, wk, wv]
        key = tuple((p.data_ptr(), p._version) for p in params)
        if key != self._packed_key:
            self._packed = pack_qkv(ln, wq, wk, wv, self.head_dim)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n, hd = h * w, self.head_dim
        nh = c // hd
        xf = x.permute(0, 2, 3, 1).reshape(b, n, c)
        kernels = self.impl == "auto"
        if kernels and sublayer_supported(n, c, hd, x.dtype):
            ln, wq, wk, wv = self._qkv_args()
            out = fused_attention_sublayer(
                xf, ln, wq, wk, wv, self.proj.weight, self.proj.bias, h, w,
                self.rope_pairing, hd, self.use_rope,
                packed=self._packed_qkv() if x.is_cuda else None)
        else:
            if kernels and kernel_supported(n, c, hd, x.dtype):
                q, k, v = ln_qkv_rope(
                    xf, *self._qkv_args(), h, w, self.rope_pairing, hd,
                    self.use_rope,
                    packed=self._packed_qkv() if x.is_cuda else None)
                q, k, v = (t.reshape(b, n, nh, hd) for t in (q, k, v))
            else:
                q = self.to_q(self.norm_q(xf)).reshape(b, n, nh, hd)
                k = self.to_k(self.norm_k(xf)).reshape(b, n, nh, hd)
                v = self.to_v(self.norm_v(xf)).reshape(b, n, nh, hd)
                if self.use_rope:
                    q = apply_rope2d(q, h, w, self.rope_pairing)
                    k = apply_rope2d(k, h, w, self.rope_pairing)
            out = xla_attention(q, k, v, hd ** -0.5)
            out = self.proj(out.reshape(b, n, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)
