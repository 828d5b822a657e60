"""Global self-attention over feature maps, with QKV-norm and 2D RoPE
(PyTorch port of ``ops/attention.py``).

Three separate LayerNorms on the block input, bias-free Q/K/V linears, heads
of ``head_dim``, 2D RoPE on Q and K, softmax at scale head_dim**-0.5, and an
output projection with bias.

Sublayer dispatch (``AttentionRoPE``), as in the JAX module:

- ``impl='auto'`` (inference) where the JAX package takes its sublayer
  kernel (``sublayer_supported``: N <= 1024 and a head group that fits its
  VMEM budget) and the kernels' limits hold: the whole sublayer runs as
  ``fused_attention_sublayer`` (three Hopper kernels);
- ``impl='auto'`` elsewhere within the kernels' limits (stage 2 at 256px,
  N=4096; 512px stage 4, N=1024 at C=1536): the ``ln_qkv_rope`` kernel, then
  :func:`core_attention`, then the projection as a plain matmul (the JAX
  package also leaves it to XLA);
- ``impl='fused'``: the kernel routes of ``'auto'`` where their gates hold,
  and :func:`core_attention` then takes the plain core (stage 2 at 256px:
  ``ln_qkv_rope``, then the plain chunked core, not the flash forward), as
  the JAX package's ``'fused'`` lets its two sublayer kernels run and falls
  through its ``core_attention`` to plain XLA;
- every other case (``auto_train``, ``xla``, ``pallas``, other head widths,
  float32, ``fuse_qkv``): the composable path -- plain LayerNorms and
  linears, ``apply_rope2d``, :func:`core_attention`, the projection. With
  ``fuse_qkv`` its three LayerNorms and Q/K/V products are one
  shared-statistics normalisation and one [C, 3C] product whose weight
  folds the norms' affines in (``diag(g_i) W_i``, bias ``b_i W_i``; the
  same parameters), and both kernel routes are off, as in the JAX module;
- under tensor parallelism (``model_group`` set by
  ``parallel.shard_params``): this rank's columns (``to_q/to_k/to_v`` C ->
  W = C/m, the projection W -> C with its partial products summed over the
  group, then its bias once), the JAX package's placement; where W cuts a
  head (heads % m != 0) q, k and v are gathered over the group for the
  core and each rank keeps its columns of the core's output (route
  ``gathered_heads``, :meth:`AttentionRoPE.partial_heads`). With
  ``impl='auto'`` and no gradient
  (serving) where the kernels' gates hold at width W: where
  ``sublayer_supported(..., W)`` holds (N <= 1024) the whole local sublayer
  on the kernels (``hopper.fused_attention_block.local_sublayer``: route
  ``local_sublayer``), elsewhere (stage 2, N=4096) ``ln_qkv_rope`` ->
  :func:`core_attention` -> the partial projection on ``proj_bias_gemm``
  (route ``local_ln_qkv_rope``); otherwise (training, other widths,
  float32, dropout) the composable path on the local heads (route
  ``local_heads``); dropout acts on the reduced output, where JAX applies
  it, every rank of the model group drawing one mask (``layers.dropout``);
- under an ambient context group (``parallel.context``: the map's rows
  split over it), whatever ``impl``: the composable path with the RoPE rows
  of this rank's offset and the exact ring
  (``parallel.ring_attention.context_parallel_attention``, the flash
  kernels per ring step) in the place of :func:`core_attention`, as the JAX
  module's gates keep its sublayer kernels out under context; on this
  rank's heads under tensor parallelism too.

:func:`route_counts` counts each forward's route by name ('sublayer',
``'ln_qkv_rope'``, ``'composable'``, ``'local_sublayer'``,
``'local_ln_qkv_rope'``, ``'local_heads'``, ``'gathered_heads'``, ``'ring'``).

:func:`core_attention` picks the core by token count as ``core_attention``
in the JAX package does, with the flash kernels
(``hopper/flash_attention.py``) in the place of the Pallas ``pallas`` band
and the whole-head kernel (``hopper/small_attention.py``) in the place of
its ``pallas_small`` band.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F
from torch import nn

from .hopper.flash_attention import flash_attention, flash_supported
from .hopper.fused_attention_block import (fused_attention_sublayer,
                                           kernel_supported, ln_qkv_rope,
                                           local_sublayer, pack_proj, pack_qkv,
                                           sublayer_supported)
from .hopper.small_attention import small_attention
from ..parallel import context as cp
from ..parallel.collectives import (copy_to_group, gather_from_group, reduce_from_group,
                                    scatter_to_group)
from ..parallel.ring_attention import context_parallel_attention
from .layers import CachedOperands, Linear, dropout, matmul_f32
from .norms import LayerNorm
from .rope import apply_rope2d

# Route name -> AttentionRoPE forwards since the last reset.
_ROUTES: collections.Counter = collections.Counter()


def reset_route_counts() -> None:
    _ROUTES.clear()


def route_counts() -> dict[str, int]:
    return dict(_ROUTES)

IMPLS = ("auto", "auto_train", "fused", "xla", "xla_chunked", "pallas", "pallas_small")

# Token-count bands of the JAX package's core_attention.
_XLA_FULL_SOFTMAX_MAX_TOKENS = 2048
_PALLAS_MID_BAND = (1024, 2048)
_SMALL_KERNEL_MAX_TOKENS = 1024
# Inference ('auto') takes the flash kernel from this token count on. The
# JAX package's 8192 was tuned on a TPU; on an H100 the flash forward beats
# the plain chunked core already at N=4096 (b32, 6 heads: 3.05 against
# 25.2 ms, chip_smoke.py phase 2), so the port's threshold is 4096.
_PALLAS_MIN_TOKENS = 4096
# Training ('auto_train') takes it from N=4096: its backward saves only o and
# the logsumexp, where the plain core's saves the [B, h, N, N] weights.
_PALLAS_MIN_TOKENS_TRAIN = 4096

# Query rows per chunk of the plain core: bounds the fp32 logits to
# [B*h, chunk, N] (at b32, stage 2: 3.2 GB instead of 12.9 GB unchunked).
_CHUNK = 1024


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
        logits = matmul_f32(qh[:, r0:r0 + _CHUNK], kt)
        weights = torch.softmax(logits if exact else logits.mul_(scale),
                                dim=-1).to(v.dtype)
        del logits
        if weights.dtype == torch.float32:
            out[:, r0:r0 + _CHUNK] = torch.bmm(weights, vh)
        else:
            out[:, r0:r0 + _CHUNK] = matmul_f32(weights, vh).to(v.dtype)
    return out.reshape(b, h, n, d).permute(0, 2, 1, 3)


def core_impl(n: int, impl: str, kernels_ok: bool) -> str:
    """The core that ``impl`` resolves to at N tokens, as the JAX package's
    ``core_attention`` picks it: 'auto'/'auto_train' choose by N -- the mid
    band (1024..2048, inference only) takes the whole-head kernel
    ('pallas_small') for N <= 1024 and the flash kernel ('pallas') above;
    N <= 2048 otherwise takes the plain core ('xla'); from
    ``_PALLAS_MIN_TOKENS`` (``_PALLAS_MIN_TOKENS_TRAIN`` for 'auto_train') on,
    the flash kernel. ``kernels_ok`` (``flash_supported``: CUDA, bf16,
    head_dim 64, N % 64 == 0) stands where the JAX package asks for a TPU.
    Any other ``impl`` is returned as it is ('fused' then takes the plain
    core in :func:`core_attention`, as the JAX package's does)."""
    if impl not in ("auto", "auto_train"):
        return impl
    min_pallas = _PALLAS_MIN_TOKENS_TRAIN if impl == "auto_train" else _PALLAS_MIN_TOKENS
    lo, hi = _PALLAS_MID_BAND
    if impl == "auto" and kernels_ok and lo <= n <= hi:
        return "pallas_small" if n <= _SMALL_KERNEL_MAX_TOKENS else "pallas"
    if n <= _XLA_FULL_SOFTMAX_MAX_TOKENS:
        return "xla"
    if kernels_ok and n >= min_pallas:
        return "pallas"
    return "xla_chunked"


def core_attention(q, k, v, scale: float, impl: str = "auto") -> torch.Tensor:
    """Dispatch the attention core; q/k/v [B, N, heads, head_dim]. The
    choice is :func:`core_impl`'s. 'pallas' asks for the flash kernels,
    'pallas_small' for the whole-head kernel (N <= 1024); for CPU tensors
    each computes its plain version. 'xla' and 'xla_chunked' run the plain
    query-chunked core."""
    impl = core_impl(q.shape[1], impl, flash_supported(q))
    if impl == "pallas":
        return flash_attention(q, k, v, scale)
    if impl == "pallas_small":
        return small_attention(q, k, v, scale)
    return xla_attention(q, k, v, scale)


class AttentionRoPE(CachedOperands, nn.Module):
    """Multi-head global attention on an NCHW feature map. ``dropout`` acts
    on the output projection in a call with ``deterministic=False``, which
    also keeps the sublayer kernels out (the JAX gates' ``dropout == 0.0 or
    deterministic``). ``fuse_qkv`` folds the three QKV LayerNorms' affines
    into one product (module docstring); the model does not set it, as the
    JAX model does not."""

    def __init__(self, dim: int, head_dim: int = 64, use_rope: bool = True,
                 rope_pairing: str = "reference", impl: str = "auto", *,
                 fuse_qkv: bool = False, dropout: float = 0.0, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
        self.dim, self.head_dim = dim, head_dim
        self.use_rope, self.rope_pairing, self.impl = use_rope, rope_pairing, impl
        self.fuse_qkv, self.dropout = fuse_qkv, dropout
        kw = dict(device=device, dtype=param_dtype)
        self.norm_q = LayerNorm(dim, **kw)
        self.norm_k = LayerNorm(dim, **kw)
        self.norm_v = LayerNorm(dim, **kw)
        self.to_q = Linear(dim, dim, bias=False, **kw)
        self.to_k = Linear(dim, dim, bias=False, **kw)
        self.to_v = Linear(dim, dim, bias=False, **kw)
        self.proj = Linear(dim, dim, bias=True, **kw)
        # The model group of tensor parallelism (parallel.shard_params):
        # to_q/to_k/to_v and proj then hold this rank's heads. The group
        # whose ranks draw one dropout mask (any placement's model group).
        self.model_group = self.dropout_group = None

    def _qkv_args(self):
        ln = tuple((m.weight, m.bias) for m in (self.norm_q, self.norm_k, self.norm_v))
        return ln, self.to_q.weight, self.to_k.weight, self.to_v.weight

    def _packed_qkv(self):
        """pack_qkv of the current weights, rebuilt when any of them changes."""
        ln, wq, wk, wv = self._qkv_args()
        params = [t for pair in ln for t in pair] + [wq, wk, wv]
        return self._cached("qkv", params,
                            lambda: pack_qkv(ln, wq, wk, wv, self.head_dim))

    def _packed_proj(self):
        """The projection's kernel operands (bf16 weight, fp32 bias), cast
        once and rebuilt when either parameter changes. Under tensor
        parallelism the partial projection's: this rank's [C, W] columns and
        a zero bias (the bias is added once, after the sum)."""
        wp, bp = self.proj.weight, self.proj.bias
        if self.model_group is not None:
            return self._cached("proj_partial", (wp,), lambda: pack_proj(wp, None))
        return self._cached("proj", (wp, bp), lambda: pack_proj(wp, bp))

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        b, c, h, w = x.shape
        n, hd = h * w, self.head_dim
        nh = c // hd
        xf = x.permute(0, 2, 3, 1).reshape(b, n, c)
        # The sublayer kernels serve inference ('auto', 'fused'); training,
        # the explicit cores and the folded QKV keep the composable path, as
        # in the JAX module. A tensor-parallel head shard (q/k/v width
        # W = C/m) takes the local routes (module docstring).
        kernels = (self.impl in ("auto", "fused") and not self.fuse_qkv
                   and (self.dropout == 0.0 or deterministic)
                   and cp.context_axis_size() == 1)
        grid = self._grid(h, w, x.device)
        if self.model_group is not None:
            out = self._local_heads(xf, h, w, kernels, grid)
        elif kernels and sublayer_supported(n, c, hd, x.dtype):
            _ROUTES["sublayer"] += 1
            ln, wq, wk, wv = self._qkv_args()
            out = fused_attention_sublayer(
                xf, ln, wq, wk, wv, self.proj.weight, self.proj.bias, h, w,
                self.rope_pairing, hd, self.use_rope,
                packed=self._packed_qkv() if x.is_cuda else None,
                packed_proj=self._packed_proj() if x.is_cuda else None)
        else:
            if kernels and kernel_supported(n, c, hd, x.dtype):
                _ROUTES["ln_qkv_rope"] += 1
                q, k, v = ln_qkv_rope(
                    xf, *self._qkv_args(), h, w, self.rope_pairing, hd,
                    self.use_rope,
                    packed=self._packed_qkv() if x.is_cuda else None)
                q, k, v = (t.reshape(b, n, nh, hd) for t in (q, k, v))
            else:
                _ROUTES["composable" if cp.context_axis_size() == 1 else "ring"] += 1
                q, k, v = (t.reshape(b, n, nh, hd) for t in self._qkv(xf))
                q, k = self._rope(q, k, h, w, grid)
            out = self._core(q, k, v, grid)
            out = self.proj(out.reshape(b, n, c))
        if self.dropout > 0.0 and not deterministic:
            # On the whole (under tensor parallelism: reduced) output, one
            # mask over the model group.
            out = dropout(out, self.dropout, self.dropout_group)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)

    def _qkv(self, xf: torch.Tensor, group=None) -> tuple:
        """The composable route's q, k, v [B, N, W] (W: ``to_q``'s rows,
        this rank's heads under tensor parallelism): the three LayerNorms
        and bias-free products, or with ``fuse_qkv`` one shared-statistics
        normalisation in fp32, x-hat cast to x's dtype, and the folded
        product (fp32 accumulation, the folded bias added in fp32, one
        cast). ``group``: the model group over which the input's gradient
        is summed (``copy_to_group``)."""
        if not self.fuse_qkv:
            pairs = ((self.to_q, self.norm_q), (self.to_k, self.norm_k), (self.to_v, self.norm_v))
            if group is None:
                return tuple(lin(norm(xf)) for lin, norm in pairs)
            return tuple(lin(copy_to_group(norm(xf), group)) for lin, norm in pairs)
        b, n, c = xf.shape
        x32 = xf.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        xhat = ((x32 - mean) * torch.rsqrt(var + self.norm_q.eps)).to(xf.dtype)
        if group is not None:
            xhat = copy_to_group(xhat, group)
        weight, bias = self._folded_qkv(xf.dtype, group)
        qkv = (matmul_f32(xhat.reshape(b * n, c), weight.t()) + bias).to(xf.dtype)
        return qkv.reshape(b, n, qkv.shape[-1]).chunk(3, dim=-1)

    def _folded_qkv(self, dtype: torch.dtype, group=None):
        """The folded QKV operands of the current parameters: the [3W, C]
        weight (row block i: ``W_i`` scaled by norm i's ``g`` on its input
        axis, in fp32, then cast to ``dtype``) and the fp32 [3W] bias
        (``W_i b_i``). Cached per parameter version; a call that autograd
        records folds under autograd. Under tensor parallelism (``group``)
        each rank folds its own rows, so the whole LayerNorm affines'
        gradients are summed over the group (``copy_to_group``), as the
        unfolded route sums the normalised input's."""
        ln, wq, wk, wv = self._qkv_args()
        params = [t for pair in ln for t in pair] + [wq, wk, wv]

        def fold():
            ws = (wq, wk, wv)
            affines = ln if group is None else tuple(
                (copy_to_group(g, group), copy_to_group(bb, group)) for g, bb in ln)
            weight = torch.cat([wi.float() * g.float() for (g, _), wi in zip(affines, ws)])
            bias = torch.cat([F.linear(bb.float(), wi.float())
                              for (_, bb), wi in zip(affines, ws)])
            return weight.to(dtype), bias

        return self._cached(f"fused_qkv_{dtype}", params, fold, differentiable=True)

    @staticmethod
    def _grid(h: int, w: int, device):
        """Under an ambient context group, (global rows, this rank's first
        row, every rank's token count) of the (h, w) map this rank holds
        rows of (the split of ``parallel.context``); None without one."""
        state = cp.current()
        if state is None:
            return None
        rows = state.rows_of(h, w, device)
        split = state.split(rows)
        return rows, split[state.rank][0], [(hi - lo) * w for lo, hi in split]

    def _rope(self, q, k, h, w, grid=None):
        """RoPE on q and k of an (h, w) map: under context (``grid``), this
        rank's rows of the global map's table."""
        if not self.use_rope:
            return q, k
        height, first = (h, 0) if grid is None else grid[:2]
        return (apply_rope2d(q, height, w, self.rope_pairing, first),
                apply_rope2d(k, height, w, self.rope_pairing, first))

    def _core(self, q, k, v, grid=None):
        """:func:`core_attention`, or under context (``grid``) the ring over
        every rank's token chunk."""
        if grid is not None:
            return context_parallel_attention(q, k, v, self.head_dim ** -0.5, sizes=grid[2])
        return core_attention(q, k, v, self.head_dim ** -0.5, self.impl)

    def partial_heads(self, xf: torch.Tensor, h: int, w: int, grid=None) -> torch.Tensor:
        """This rank's part of the sublayer on tokens ``xf`` [B, N, C]:
        LayerNorms, the local q/k/v (C -> W = C/m columns; with ``fuse_qkv``
        the fold of this rank's rows of each W_i, exact since the fold is
        row by row), RoPE, the core and the local projection (W -> C, no
        bias); summed over the model group this is the sublayer's output
        less the projection's bias. The composable route (the core takes its
        kernels by token count; under context, ``grid``, the ring).

        Where W holds whole heads (heads % m == 0) the core runs on this
        rank's heads (route ``local_heads``). Where the JAX rule's column
        split cuts a head (route ``gathered_heads``), q, k and v are
        gathered over the model group, every rank runs the core on every
        head, and keeps its W columns of the core's output for its rows of
        ``proj``. The gather's backward keeps this rank's columns of the
        core's gradient (every rank computes it whole, so it is counted
        once) and the column take's backward gathers the output gradient
        from every rank's projection."""
        b, n, c = xf.shape
        hd, group = self.head_dim, self.model_group
        width = self.to_q.weight.shape[0]
        q, k, v = self._qkv(xf, group)
        if width % hd == 0:
            _ROUTES["local_heads"] += 1
            heads = width // hd
        else:
            _ROUTES["gathered_heads"] += 1
            q, k, v = (gather_from_group(t, 2, group) for t in (q, k, v))
            heads = q.shape[2] // hd
        q, k, v = (t.reshape(b, n, heads, hd) for t in (q, k, v))
        q, k = self._rope(q, k, h, w, grid)
        out = self._core(q, k, v, grid).reshape(b, n, heads * hd)
        if width % hd:
            out = scatter_to_group(out, 2, group)
        return F.linear(out, self.proj.weight.to(xf.dtype))

    def local_kernel_heads(self, xf: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """This rank's heads on the sublayer kernels (no gradient): the
        partial products of :meth:`partial_heads`, through
        ``local_sublayer`` where ``sublayer_supported(..., W)`` holds, else
        ``ln_qkv_rope`` -> :func:`core_attention` -> the partial projection
        on ``proj_bias_gemm``. The caller checks the kernels' gate
        (``kernel_supported(..., W)``)."""
        b, n, c = xf.shape
        hd, width = self.head_dim, self.to_q.weight.shape[0]
        ln, wq, wk, wv = self._qkv_args()
        core = None
        if sublayer_supported(n, c, hd, xf.dtype, width):
            _ROUTES["local_sublayer"] += 1
        else:
            _ROUTES["local_ln_qkv_rope"] += 1

            def core(q, k, v):
                q, k, v = (t.reshape(b, n, width // hd, hd) for t in (q, k, v))
                return self._core(q, k, v).reshape(b, n, width)

        cuda = xf.is_cuda
        return local_sublayer(xf, ln, wq, wk, wv, self.proj.weight, h, w, self.rope_pairing,
                              hd, self.use_rope, packed=self._packed_qkv() if cuda else None,
                              packed_proj=self._packed_proj() if cuda else None, core=core)

    def _local_heads(self, xf, h, w, kernels, grid=None):
        width = self.to_q.weight.shape[0]
        # The local kernels have no backward: a forward that builds a graph
        # takes the composable route; so does a split that cuts a head (the
        # kernels' gate refuses its width).
        if (kernels and not torch.is_grad_enabled()
                and kernel_supported(xf.shape[1], xf.shape[2], self.head_dim, xf.dtype, width)):
            part = self.local_kernel_heads(xf, h, w)
        else:
            part = self.partial_heads(xf, h, w, grid)
        out = reduce_from_group(part, self.model_group)
        return out + self.proj.bias.to(xf.dtype)
