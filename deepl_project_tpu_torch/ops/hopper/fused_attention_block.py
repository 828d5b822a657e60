"""Attention sublayer kernels for Hopper (port of
``deepl_project_tpu/ops/pallas/fused_attention_block.py``).

Three hand-written CUDA kernels (``deepl_project_tpu_torch/csrc``) carry the
two TPU kernels of that file:

- ``ln_qkv_rope``: LN statistics + three affines + bias-free Q/K/V + RoPE, one
  GEMM with an LN prologue and a RoPE epilogue. It is ``fused_qkv_rope`` whole
  and the first half of ``fused_attention_sublayer``.
- ``attention_core``: softmax(q k^T * scale) v for N <= 1024, head_dim 64,
  on the flash forward's wgmma + TMA tile (``csrc/flash_fwd_wgmma.cuh``).
  It rounds the unnormalised weights to bf16 and divides o by the row sum
  at the end, as the flash forward does; the TPU ``_kernel`` and
  :func:`attention_core_reference` normalise first and then round. That is
  a known port deviation, within two bf16 steps (the card tests hold the
  kernel to the plain version): normalising first would need a second
  Q K^T pass.
- ``proj_bias_gemm``: the output projection with its bias.

``fused_attention_sublayer`` = ``ln_qkv_rope`` -> ``attention_core`` ->
``proj_bias_gemm``. Each wrapper launches its kernel for a CUDA tensor and
raises on what the kernel does not take; for a CPU tensor it computes its
plain PyTorch version, which is the one beside it. The plain versions are
ports of ``qkv_rope_reference`` and ``_reference``.

``ln_qkv_rope`` and ``fused_attention_sublayer`` are differentiable: each is
a ``torch.autograd.Function`` whose forward launches the kernels and whose
backward recomputes the plain version under autograd and returns its VJP,
as ``_make_qkv_op`` / ``_make_op`` do in the JAX package. ``attention_core``
and ``proj_bias_gemm`` alone have no backward and raise when asked for one.

Weights are in nn.Linear layout ([out, in]). q and k come back in the
per-head permuted layout ([even pair entries | odd pair entries] per head,
RoPE applied); v and every output stay in the natural layout. Attention is
invariant to one per-head permutation of both q and k.

Cast order: x-hat is rounded to the compute dtype before each branch's fp32
affine (as in ``_reference``, ``qkv_rope_reference`` and the TPU ``_kernel``;
``_qkv_rope_kernel`` keeps x-hat in fp32, one bf16 rounding apart).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..rope import apply_rope2d, rope2d_tables
from . import build

_LN_EPS = 1e-5
HEAD_DIM = 64
MAX_SUBLAYER_TOKENS = 1024

# (kernel name, tokens per image, channels) -> launches since the last reset.
_LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last reset."""
    out: dict[str, int] = {}
    for (name, _, _), cnt in _LAUNCHES.items():
        out[name] = out.get(name, 0) + cnt
    return out


def launch_counts_by_shape() -> dict[tuple, int]:
    """(kernel name, N, C) -> launches since the last reset."""
    return dict(_LAUNCHES)


def kernel_supported(n: int, c: int, head_dim: int, dtype) -> bool:
    """The kernels' own limits: head_dim 64, C % 128 == 0 (a 128-column
    GEMM tile lies in one of the q/k/v branches), N % 64 == 0 (64-token
    attention tiles), bf16."""
    return (head_dim == HEAD_DIM and c % 128 == 0 and n % 64 == 0
            and dtype == torch.bfloat16)


def proj_supported(c: int, dtype) -> bool:
    """``proj_bias_gemm``'s limits: bf16, C % 128 == 0 (K = Nout = C: 64-deep
    stages, 128-wide output tiles). Any row count."""
    return c > 0 and c % 128 == 0 and dtype == torch.bfloat16


def sublayer_kernels_supported(n: int, c: int, head_dim: int, dtype) -> bool:
    """Limits of the sublayer kernels themselves: the kernels' plus
    N <= 1024, the TPU sublayer kernel's bound, which the dispatch keeps."""
    return n <= MAX_SUBLAYER_TOKENS and kernel_supported(n, c, head_dim, dtype)


def _pick_group(num_heads: int, head_dim: int, n: int, c: int) -> int:
    """The JAX package's ``_pick_group``: the largest head group whose
    working set fits the TPU sublayer kernel's 14 MiB of VMEM, 0 when none
    does. A port-owned copy, used only to take the JAX package's route."""
    best = 0
    for g in range(1, num_heads + 1):
        if num_heads % g:
            continue
        hgd = g * head_dim
        if hgd % 128 and hgd != c:
            continue
        est = (2 * n * c * 2 + n * c * 2 + n * c * 2 + n * c * 4
               + 3 * n * hgd * 2 + 2 * 4 * c * hgd * 2
               + min(n, 256) * n * 4 + 4 * n * (head_dim // 2) * 4
               + 256 * c * 2)
        if est <= 14 * 1024 * 1024:
            best = g
    return best


def sublayer_supported(n: int, c: int, head_dim: int, dtype) -> bool:
    """Dispatch gate of the whole sublayer: the kernels' limits and the JAX
    package's route, which takes its sublayer kernel only where ``supported()``
    holds (N <= 1024, N % 256 == 0, a head group that fits its VMEM budget).
    That route is kept so that dispatch stays comparable with the JAX
    package; it is not a limit of the H100. Elsewhere (512px stage 4: N=1024,
    C=1536) the sublayer runs ``ln_qkv_rope``, ``core_attention`` (whose mid
    band takes ``small_attention``) and the projection."""
    return (sublayer_kernels_supported(n, c, head_dim, dtype) and n % 256 == 0
            and c % head_dim == 0 and _pick_group(c // head_dim, head_dim, n, c) > 0)


def head_perm(num_heads: int, head_dim: int) -> np.ndarray:
    """Per-head channel permutation: even pair entries first, odd second."""
    idx = []
    for h in range(num_heads):
        base = h * head_dim
        idx.extend(base + i for i in range(0, head_dim, 2))
        idx.extend(base + i for i in range(1, head_dim, 2))
    return np.asarray(idx, dtype=np.int64)


def pack_qkv(ln_params, wq, wk, wv, head_dim: int = HEAD_DIM):
    """Kernel operands from the module's parameters: w [3C, C] bf16 with the
    q and k output channels permuted per head, and gb [6, C] fp32 holding
    (gq, bq, gk, bk, gv, bv)."""
    c = wq.shape[0]
    perm = torch.from_numpy(head_perm(c // head_dim, head_dim)).to(wq.device)
    w = torch.cat([wq[perm], wk[perm], wv]).to(torch.bfloat16).contiguous()
    gb = torch.stack([t.float() for pair in ln_params for t in pair]).contiguous()
    return w, gb


def pack_proj(wp, bp):
    """``proj_bias_gemm``'s operands from the module's parameters: the weight
    in bf16 ([C, C], nn.Linear layout) and the bias in fp32."""
    return wp.to(torch.bfloat16).contiguous(), bp.float().contiguous()


def _layer_norm_hat(xf: torch.Tensor) -> torch.Tensor:
    x32 = xf.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + _LN_EPS)).to(xf.dtype)


def _affine_matmul(xhat, g, b, w):
    """bf16(bf16(xhat * g + b) @ w.T) with fp32 accumulation."""
    xt = (xhat.float() * g.float() + b.float()).to(xhat.dtype)
    return (xt.float() @ w.to(xhat.dtype).float().t()).to(xhat.dtype)


def qkv_rope_reference(xf, ln_params, wq, wk, wv, height, width,
                       pairing="reference", head_dim=HEAD_DIM, use_rope=True):
    """Plain version of ``ln_qkv_rope`` (port of ``qkv_rope_reference``),
    including the permuted q/k layout. xf [B, N, C] -> (q, k, v) [B, N, C]."""
    b, n, c = xf.shape
    nh = c // head_dim
    xhat = _layer_norm_hat(xf)
    perm = torch.from_numpy(head_perm(nh, head_dim)).to(xf.device)
    outs = []
    for (g, bb), w, permute in zip(ln_params, (wq, wk, wv), (True, True, False)):
        outs.append(_affine_matmul(xhat, g, bb, w[perm] if permute else w))
    q, k, v = outs
    if use_rope:
        ca, sa, cb, sb = (t[None, :, None, :] for t in rope2d_tables(
            head_dim, height, width, pairing, xf.device))
        hd2 = head_dim // 2

        def rot(t):
            t4 = t.reshape(b, n, nh, head_dim).float()
            e, o = t4[..., :hd2], t4[..., hd2:]
            out = torch.cat([e * ca - o * sa, e * sb + o * cb], dim=-1)
            return out.reshape(b, n, c).to(t.dtype)

        q, k = rot(q), rot(k)
    return q, k, v


def attention_core_reference(q, k, v, scale, head_dim=HEAD_DIM):
    """Plain version of ``attention_core``: [B, N, C] x3 -> [B, N, C], fp32
    scores and softmax, weights rounded to the compute dtype before P.V."""
    b, n, c = q.shape
    nh = c // head_dim
    q4, k4, v4 = (t.reshape(b, n, nh, head_dim).transpose(1, 2) for t in (q, k, v))
    logits = q4.float() @ k4.float().transpose(-1, -2)
    weights = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    o = (weights.float() @ v4.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, n, c)


def proj_bias_reference(o, wp, bp):
    """Plain version of ``proj_bias_gemm``: bf16(o @ wp.T + bp), fp32."""
    return (o.float() @ wp.to(o.dtype).float().t() + bp.float()).to(o.dtype)


def sublayer_reference(xf, ln_params, wq, wk, wv, wp, bp, height, width,
                       pairing="reference", head_dim=HEAD_DIM, use_rope=True):
    """Plain version of ``fused_attention_sublayer`` (port of ``_reference``,
    natural q/k layout with interleaved RoPE)."""
    b, n, c = xf.shape
    nh = c // head_dim
    xhat = _layer_norm_hat(xf)
    q, k, v = (_affine_matmul(xhat, g, bb, w).reshape(b, n, nh, head_dim)
               for (g, bb), w in zip(ln_params, (wq, wk, wv)))
    if use_rope:
        q = apply_rope2d(q, height, width, pairing)
        k = apply_rope2d(k, height, width, pairing)
    o = attention_core_reference(q.reshape(b, n, c), k.reshape(b, n, c),
                                 v.reshape(b, n, c), head_dim ** -0.5, head_dim)
    return proj_bias_reference(o, wp, bp)


def _check(name, t, shape=None):
    if not t.is_cuda or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected a CUDA bf16 tensor, got "
                         f"{t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ln_qkv_rope_kernel(xf, w, gb, height, width, pairing, head_dim, use_rope):
    """Launch ``ln_qkv_rope``: xf [B, N, C] -> [B, N, 3C] (q | k | v)."""
    b, n, c = xf.shape
    xf = xf.contiguous()
    ca, sa, cb, sb = rope2d_tables(head_dim, height, width, pairing, xf.device)
    out = torch.empty(b, n, 3 * c, device=xf.device, dtype=xf.dtype)
    build.launch("ln_qkv_rope", xf.data_ptr(), w.data_ptr(), gb.data_ptr(),
                 ca.data_ptr(), sa.data_ptr(), cb.data_ptr(), sb.data_ptr(),
                 out.data_ptr(), b * n, n, c, int(bool(use_rope)), _stream())
    _LAUNCHES[("ln_qkv_rope", n, c)] += 1
    return out


def _plain_vjp(ctx, fn, cotangents):
    """Gradients of the plain ``fn`` at the saved inputs, for the inputs
    that need them (None for the others): the backward of a kernel that the
    JAX package differentiates through its plain reference."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        wrt = [t for t in ins if t.requires_grad]
        if not wrt:
            return [None] * len(saved)
        grads = iter(torch.autograd.grad(fn(*ins), wrt, cotangents, allow_unused=True))
    return [next(grads) if need else None for need in needs]


def _ln_flat(ln_params):
    return [t for pair in ln_params for t in pair]


def _ln_pairs(flat):
    return tuple(zip(flat[0::2], flat[1::2]))


class _LnQkvRope(torch.autograd.Function):
    """ln_qkv_rope with a backward: the forward launches the kernel, the
    backward is the VJP of ``qkv_rope_reference`` (as ``_make_qkv_op`` in
    the JAX package). Inputs: xf, the six LN tensors, wq, wk, wv; the packed
    kernel operands and the static arguments are not differentiated."""

    @staticmethod
    def forward(ctx, xf, gq, bq, gk, bk, gv, bv, wq, wk, wv, packed, meta):
        ctx.meta = meta
        ctx.save_for_backward(xf, gq, bq, gk, bk, gv, bv, wq, wk, wv)
        return _ln_qkv_rope_kernel(xf, *packed, *meta)

    @staticmethod
    def backward(ctx, dout):
        meta = ctx.meta

        def plain(xf, *rest):
            return torch.cat(qkv_rope_reference(xf, _ln_pairs(rest[:6]), *rest[6:],
                                                *meta), dim=-1)

        return (*_plain_vjp(ctx, plain, dout), None, None)


def ln_qkv_rope(xf, ln_params, wq, wk, wv, height, width, pairing="reference",
                head_dim=HEAD_DIM, use_rope=True, packed=None):
    """LN trio + QKV projections + 2D RoPE: xf [B, N, C] -> (q, k, v), each
    [B, N, C], q/k permuted per head with RoPE applied. ``packed`` is the
    cached result of :func:`pack_qkv` for these weights. Differentiable with
    respect to xf, the LN affines and wq/wk/wv (not through ``packed``)."""
    if xf.device.type == "cpu":
        return qkv_rope_reference(xf, ln_params, wq, wk, wv, height, width,
                                  pairing, head_dim, use_rope)
    b, n, c = xf.shape
    _check("ln_qkv_rope x", xf)
    if not kernel_supported(n, c, head_dim, xf.dtype) or n != height * width:
        raise ValueError(f"ln_qkv_rope: unsupported shape N={n} C={c} "
                         f"head_dim={head_dim} ({height}x{width})")
    w, gb = packed if packed is not None else pack_qkv(ln_params, wq, wk, wv,
                                                       head_dim)
    _check("ln_qkv_rope w", w, (3 * c, c))
    if gb.shape != (6, c) or gb.dtype != torch.float32 or not gb.is_cuda:
        raise ValueError(f"ln_qkv_rope: LN affines must be a CUDA fp32 [6, {c}] tensor")
    meta = (height, width, pairing, head_dim, use_rope)
    out = _LnQkvRope.apply(xf, *_ln_flat(ln_params), wq, wk, wv,
                           (w.contiguous(), gb.contiguous()), meta)
    return out[..., :c], out[..., c:2 * c], out[..., 2 * c:]


def _no_backward(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward of its own; differentiate "
                           f"through fused_attention_sublayer")


def attention_core(q, k, v, scale, head_dim=HEAD_DIM):
    """softmax(q k^T * scale) v per head: [B, N, C] x3 -> [B, N, C] for
    N <= 1024. q/k/v may be column slices of one [B, N, 3C] buffer."""
    if q.device.type == "cpu":
        return attention_core_reference(q, k, v, scale, head_dim)
    _no_backward("attention_core", q, k, v)
    b, n, c = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(f"attention_core {name}", t, (b, n, c))
        if t.stride(2) != 1 or t.stride(0) != n * t.stride(1) or t.data_ptr() % 16:
            raise ValueError(f"attention_core {name}: rows must be uniformly "
                             f"strided with contiguous channels, 16-byte aligned")
    ld = q.stride(1)
    if k.stride(1) != ld or v.stride(1) != ld or ld % 8:
        raise ValueError("attention_core: q, k and v need one row stride, a "
                         "multiple of 8 elements")
    if not sublayer_kernels_supported(n, c, head_dim, q.dtype):
        raise ValueError(f"attention_core: unsupported N={n} C={c} "
                         f"head_dim={head_dim}")
    o = torch.empty(b, n, c, device=q.device, dtype=q.dtype)
    build.launch("attention_core", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), b, n, c // head_dim, ld, c, float(scale),
                 _stream())
    _LAUNCHES[("attention_core", n, c)] += 1
    return o


def proj_bias_gemm(o, wp, bp):
    """Output projection o [B, N, C] @ wp.T + bp -> [B, N, C] (wp [C, C] in
    nn.Linear layout; bias added in fp32). Operands already in bf16 and fp32
    (:func:`pack_proj`) are used as they are; others are cast on each call."""
    if o.device.type == "cpu":
        return proj_bias_reference(o, wp, bp)
    _no_backward("proj_bias_gemm", o, wp, bp)
    b, n, c = o.shape
    _check("proj_bias_gemm o", o)
    if not proj_supported(c, o.dtype):
        raise ValueError(f"proj_bias_gemm: C={c} is not a multiple of 128")
    o = o.contiguous()
    w, bias = pack_proj(wp, bp)
    _check("proj_bias_gemm w", w, (c, c))
    if bias.shape != (c,) or not bias.is_cuda:
        raise ValueError(f"proj_bias_gemm: bias must be a CUDA [{c}] tensor")
    out = torch.empty_like(o)
    build.launch("proj_bias_gemm", o.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b * n, c, c, _stream())
    _LAUNCHES[("proj_bias_gemm", n, c)] += 1
    return out


class _Sublayer(torch.autograd.Function):
    """fused_attention_sublayer with a backward: the forward launches the
    three kernels, the backward is the VJP of ``sublayer_reference`` (as
    ``_make_op`` in the JAX package). Inputs: xf, the six LN tensors, wq,
    wk, wv, wp, bp; ``packed`` holds the kernels' operands (pack_qkv's w and
    gb, then pack_proj's weight and bias), which are not differentiated."""

    @staticmethod
    def forward(ctx, xf, gq, bq, gk, bk, gv, bv, wq, wk, wv, wp, bp, packed, meta):
        ctx.meta = meta
        ctx.save_for_backward(xf, gq, bq, gk, bk, gv, bv, wq, wk, wv, wp, bp)
        c, head_dim = xf.shape[2], meta[3]
        w, gb, wpk, bpk = packed
        qkv = _ln_qkv_rope_kernel(xf, w, gb, *meta)
        o = attention_core(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                           head_dim ** -0.5, head_dim)
        return proj_bias_gemm(o, wpk, bpk)

    @staticmethod
    def backward(ctx, dout):
        meta = ctx.meta

        def plain(xf, *rest):
            return sublayer_reference(xf, _ln_pairs(rest[:6]), *rest[6:], *meta)

        return (*_plain_vjp(ctx, plain, dout), None, None)


def fused_attention_sublayer(xf, ln_params, wq, wk, wv, wp, bp, height, width,
                             pairing="reference", head_dim=HEAD_DIM,
                             use_rope=True, packed=None, packed_proj=None):
    """Whole attention sublayer on tokens xf [B, N, C] -> [B, N, C]:
    ln_qkv_rope -> attention_core -> proj_bias_gemm on the card; the port of
    ``_reference`` on the CPU. ``packed`` and ``packed_proj`` are the cached
    results of :func:`pack_qkv` and :func:`pack_proj` for these weights.
    Differentiable with respect to xf and every parameter (the backward
    recomputes the plain version from the parameters themselves)."""
    if xf.device.type == "cpu":
        return sublayer_reference(xf, ln_params, wq, wk, wv, wp, bp, height,
                                  width, pairing, head_dim, use_rope)
    b, n, c = xf.shape
    _check("fused_attention_sublayer x", xf)
    if not sublayer_kernels_supported(n, c, head_dim, xf.dtype) or n != height * width:
        raise ValueError(f"fused_attention_sublayer: unsupported N={n} C={c} "
                         f"head_dim={head_dim} dtype={xf.dtype}")
    w, gb = packed if packed is not None else pack_qkv(ln_params, wq, wk, wv,
                                                       head_dim)
    _check("fused_attention_sublayer w", w, (3 * c, c))
    if gb.shape != (6, c) or gb.dtype != torch.float32 or not gb.is_cuda:
        raise ValueError(f"fused_attention_sublayer: LN affines must be a CUDA "
                         f"fp32 [6, {c}] tensor")
    wpk, bpk = packed_proj if packed_proj is not None else pack_proj(wp, bp)
    meta = (height, width, pairing, head_dim, use_rope)
    return _Sublayer.apply(xf, *_ln_flat(ln_params), wq, wk, wv, wp, bp,
                           (w.contiguous(), gb.contiguous(), wpk, bpk), meta)
