"""Building blocks (PyTorch port of ``ops/blocks.py``): the CNN ResBlock and
the hybrid TransVAE block, on NCHW maps, and the per-block gradient
checkpointing of the encoder and decoder (:func:`resolve_remat_policy`,
:func:`run_block`)."""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..parallel import context as cp
from ..parallel.collectives import copy_to_group, gather_from_group
from .attention import AttentionRoPE
from .ffn import ConvFFN, StandardFFN
from .layers import Conv2d
from .norms import GroupNorm, RMSNorm, gn_groups, group_norm_silu
from .quant import QConv2d, record_amax

_aten = torch.ops.aten
# The ops whose outputs each policy keeps (every overload of each): products
# without a batch dimension (the linear layers), batched products (the plain
# attention core's QK^T and PV), convolutions.
_DOTS = (_aten.mm, _aten.addmm)
_BATCHED_DOTS = (_aten.bmm, _aten.baddbmm)
_CONVS = (_aten.convolution,)
_SAVED = {"dots": _DOTS, "dots_all": _DOTS + _BATCHED_DOTS,
          "conv_dots": _DOTS + _BATCHED_DOTS + _CONVS}


def resolve_remat_policy(name: str | None):
    """Map a config ``remat_policy`` name to a selective-checkpoint policy
    (``create_selective_checkpoint_contexts``), as the JAX package maps it to
    a ``jax.checkpoint`` policy:

    - 'none' (or None): save nothing (returns None: a plain checkpoint);
    - 'dots': save the outputs of products with no batch dimension
      (``aten.mm``/``addmm``: the linear layers);
    - 'dots_all': also the batched products (``aten.bmm``/``baddbmm``);
    - 'conv_dots': also the convolutions, so the backward recomputes only
      elementwise chains.

    The hand-written kernels are launched through ctypes, so no policy sees
    them: a checkpointed block always launches them again when it is
    recomputed, as a ``pallas_call`` in JAX is neither ``dot_general`` nor
    ``conv_general_dilated`` and is recomputed under every policy."""
    if name in (None, "none"):
        return None
    if name not in _SAVED:
        raise ValueError(f"Unknown remat policy {name!r}")
    saved = _SAVED[name]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def run_block(block: nn.Module, x: torch.Tensor, *args, remat: bool = False,
              policy=None) -> torch.Tensor:
    """``block(x, *args)``, through ``torch.utils.checkpoint`` (non-reentrant)
    under ``remat`` when the call builds a graph: the block's activations are
    dropped after the forward, except the outputs that ``policy`` (from
    :func:`resolve_remat_policy`) keeps, and recomputed in the backward.
    Dropout's global RNG state is restored for the recompute, and so is the
    ambient context group (``parallel.context``): the recompute runs its
    halo exchanges, moment all-reduces and ring again, in the forward's
    order on every rank."""
    if not (remat and torch.is_grad_enabled()):
        return block(x, *args)
    context_fn = (functools.partial(create_selective_checkpoint_contexts, policy)
                  if policy is not None else noop_context_fn)
    state = cp.current()
    fn = block if state is None else functools.partial(cp.call_in, state, block)
    return checkpoint(fn, x, *args, use_reentrant=False, context_fn=context_fn)


class ResBlock(nn.Module):
    """GroupNorm(32) -> SiLU -> 3x3 conv, twice, plus a 1x1 (or 3x3)
    shortcut when the channel count changes.

    ``quant='int8'``: the three convs are int8 (``QConv2d``), the norms and
    SiLU stay float. ``calibrate``: record the absmax of each conv's input
    (sites ``amax_h1``, ``amax_h2``, ``amax_x``) in ``self.amax``.
    Each GroupNorm -> SiLU goes through ``norms.group_norm_silu``, which
    takes the fused kernels where their gate holds (no-grad CUDA bf16).

    Under tensor parallelism (``model_group`` set by
    ``parallel.shard_params``) ``conv1`` holds this rank's output channels
    and its map is gathered whole (channels_last) before ``norm2``, which
    with SiLU and ``conv2`` runs replicated."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_conv_shortcut: bool = False, *, quant: str | None = None,
                 calibrate: bool = False, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)

        def conv(cin, cout, k):
            if quant == "int8":
                return QConv2d(cin, cout, k, device=device)
            return Conv2d(cin, cout, k, padding=k // 2, **kw)

        self.calibrate, self.amax = calibrate, {}
        self.norm1 = GroupNorm(gn_groups(in_channels), in_channels, **kw)
        self.conv1 = conv(in_channels, out_channels, 3)
        self.norm2 = GroupNorm(gn_groups(out_channels), out_channels, **kw)
        self.conv2 = conv(out_channels, out_channels, 3)
        self.shortcut = None
        if in_channels != out_channels:
            self.shortcut = conv(in_channels, out_channels, 3 if use_conv_shortcut else 1)
        self.model_group = None

    def _conv1(self, h: torch.Tensor) -> torch.Tensor:
        if self.model_group is None:
            return self.conv1(h)
        part = self.conv1(copy_to_group(h, self.model_group))
        return gather_from_group(part, 1, self.model_group).contiguous(
            memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_silu(self.norm1, x)
        if self.calibrate:
            record_amax(self, "amax_h1", h)
        h = group_norm_silu(self.norm2, self._conv1(h))
        if self.calibrate:
            record_amax(self, "amax_h2", h)
        h = self.conv2(h)
        if self.shortcut is None:
            return h + x
        if self.calibrate:
            record_amax(self, "amax_x", x)
        return h + self.shortcut(x)


class TransVAEBlock(nn.Module):
    """Pre-norm transformer block on feature maps:
    x + attn(RMSNorm(x)); x + ffn(RMSNorm(x)). ``dropout`` is active only in
    a call with ``deterministic=False`` (the attention output projection and
    the FFN, as in the JAX block)."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, head_dim: int = 64,
                 use_rope: bool = True, rope_pairing: str = "reference",
                 use_conv_ffn: bool = True, conv_ffn_type: str = "full",
                 attention_impl: str = "auto", dropout: float = 0.0, *,
                 quant: str | None = None, calibrate: bool = False, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        self.norm1 = RMSNorm(dim, device=device, dtype=param_dtype)
        self.attn = AttentionRoPE(dim, head_dim, use_rope, rope_pairing,
                                  attention_impl, dropout=dropout, **kw)
        self.norm2 = RMSNorm(dim, device=device, dtype=param_dtype)
        # quant and calibrate reach the ConvFFN only: attention stays bf16.
        self.ffn = (ConvFFN(dim, mlp_ratio, conv_ffn_type, dropout=dropout, quant=quant,
                            calibrate=calibrate, **kw) if use_conv_ffn
                    else StandardFFN(dim, mlp_ratio, dropout=dropout, **kw))

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), deterministic)
        return x + self.ffn(self.norm2(x), deterministic)
