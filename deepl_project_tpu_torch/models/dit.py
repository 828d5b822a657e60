"""Latent Diffusion Transformer over TransVAE latents (PyTorch port of
``models/dit.py``).

The paper's Table 2(b) trains a LightningDiT-B/2 on TransVAE latents and
scores it by generation FID. :class:`DiT` works on the [B, h, w, C] latent
grids of the tokenizer (f16d32 @256px: 16x16x32), channels last as in the
JAX package, and predicts the rectified-flow velocity (``training/diffusion.py``).

- adaLN-Zero conditioning on the timestep and class embeddings; the head and
  every modulation start at zero, so each block starts as the identity.
- LightningDiT's modernizations, each behind a config gate: RMSNorm in
  place of LayerNorm, SwiGLU in place of the GELU MLP, 2D RoPE on the patch
  grid ('standard' pairing) in place of a learned ``pos_embed``.
- Every Dense of the JAX model is a :class:`ops.layers.Linear` (fp32
  parameters cast to the compute dtype at the call), so the residual stream
  stays in the compute dtype (bf16) as in JAX; the norms take fp32
  statistics and cast back.
- Attention goes through ``ops.attention.core_attention``: at the CLI's
  N=64 (16x16 latents, patch 2) the plain core, at N=1024 (DiT-B/1 on 32x32
  latents) the ``small_attention`` kernel on the card.

The module tree follows the JAX tree (``patch_embed``, ``t_embed.fc1``,
``y_embed.embedding``, ``block{i}.qkv``, ..., ``head``), so
``utils.convert.load_jax_dit_params`` loads a JAX tree with ``strict=True``.

The stacked layout: with ``scan_blocks`` or ``pipeline_axis`` the blocks
are one ``ops.stack.BlockStack`` whose state_dict keys are
``blocks.block.<path>`` [depth, ...], one-to-one with JAX's
``blocks/block/...`` (JAX holds them so under the same two fields); the
forward runs the slices in order and computes what the unrolled blocks
compute, bit for bit. :func:`stack_dit_params` / :func:`unstack_dit_params`
convert a state_dict between the layouts (``utils.convert.in_model_layout``
does it on load).

``pipeline_axis``: under an ambient group of that axis
(``parallel.mesh.use_axes``) of more than one rank the stack runs as a
GPipe pipeline (``parallel.pipeline.pipeline_apply``, each stage the
consecutive slices ``PipelinePlacement.shard`` left it); without one the
slices run one after another, as the JAX model falls back to its sequential
scan. The stacked layout keeps no router loss: the JAX model's ``nn.scan``
carries only the params collection, so the sown ``moe_aux`` is dropped (a
behaviour the port mirrors, ``training/diffusion.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
import zlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.attention import IMPLS, core_attention
from ..ops.layers import Conv2d, Linear
from ..ops.moe import ExpertLinear, SwitchFFN
from ..ops.rope import apply_rope2d
from ..ops.stack import BlockStack
from ..parallel.mesh import ambient


def _affine_free_norm(x: torch.Tensor, use_rms: bool, eps: float = 1e-6) -> torch.Tensor:
    """Norm over the last axis without an affine (adaLN supplies shift and
    scale), fp32 statistics, cast back to x's dtype."""
    x32 = x.float()
    if use_rms:
        y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """DiT-{S,B,L,XL}/p geometry and the LightningDiT gates: the JAX
    package's fields and defaults, so one ``dit_config.json`` builds either
    package's model."""

    variant: str = "B"
    patch_size: int = 2
    in_channels: int = 32  # TransVAE f16d32 latent dim
    hidden_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout: float = 0.1  # CFG label dropout
    use_rmsnorm: bool = True
    use_swiglu: bool = True
    use_rope: bool = True
    learn_sigma: bool = False  # rectified flow predicts velocity only
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "auto"
    scan_blocks: bool = False
    pipeline_axis: str | None = None
    pipeline_microbatches: int = 8
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_axis: str = "expert"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def stacked(self) -> bool:
        """Whether the blocks are held in the stacked layout (JAX's
        ``scan_blocks or pipeline_axis``)."""
        return bool(self.scan_blocks or self.pipeline_axis)

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)


DIT_VARIANTS: dict[str, dict] = {
    "S": dict(hidden_dim=384, depth=12, num_heads=6),
    "B": dict(hidden_dim=768, depth=12, num_heads=12),
    "L": dict(hidden_dim=1024, depth=24, num_heads=16),
    "XL": dict(hidden_dim=1152, depth=28, num_heads=16),
}


def get_dit_config(variant: str = "B", patch_size: int = 2, **kw) -> DiTConfig:
    if variant not in DIT_VARIANTS:
        raise ValueError(f"Unknown DiT variant {variant!r}; known: {sorted(DIT_VARIANTS)}")
    spec = dict(DIT_VARIANTS[variant])
    spec.update(kw)
    return DiTConfig(variant=variant, patch_size=patch_size, **spec)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, dim] (fp32) of t in [0, 1], scaled by 1000 to
    the conventional discrete-timestep band; an odd ``dim`` gets a zero
    column."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = (t.float() * 1000.0)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, *, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.fc1 = Linear(256, dim, **kw)
        self.fc2 = Linear(dim, dim, **kw)

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.fc1(timestep_embedding(t, 256).to(dtype))
        return self.fc2(F.silu(x))


class LabelEmbedder(nn.Module):
    """Class-label table with CFG dropout: the trained null class at index
    ``num_classes`` stands in for dropped or unconditional labels. The drop
    draws come from the caller's ``torch.Generator`` (JAX draws them from its
    'label_dropout' stream: the two never give the same bits)."""

    def __init__(self, num_classes: int, dim: int, dropout: float = 0.1, *,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_classes, self.dropout = num_classes, dropout
        self.embedding = nn.Parameter(torch.empty(num_classes + 1, dim, device=device,
                                                  dtype=param_dtype))

    def forward(self, labels: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        if not deterministic and self.dropout > 0.0:
            first, total = (0, labels.shape[0]) if rows is None else rows
            u = torch.rand(total, generator=generator, device=labels.device)
            drop = u[first:first + labels.shape[0]] < self.dropout
            labels = torch.where(drop, torch.full_like(labels, self.num_classes), labels)
        return self.embedding[labels]


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _ffn_hidden(cfg: DiTConfig) -> int:
    """The FFN width: d * mlp_ratio, two thirds of it for SwiGLU (the
    param-matched width)."""
    hidden = int(cfg.hidden_dim * cfg.mlp_ratio)
    return int(2 * hidden / 3) if cfg.use_swiglu else hidden


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block on [B, N, D] tokens."""

    def __init__(self, cfg: DiTConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, hidden = cfg.hidden_dim, _ffn_hidden(cfg)
        kw = dict(device=device, dtype=cfg.params_dtype)
        self.adaln = Linear(d, 6 * d, **kw)
        self.qkv = Linear(d, 3 * d, **kw)
        self.proj = Linear(d, d, **kw)
        if cfg.moe_experts > 1:
            self.moe_ffn = SwitchFFN(d, hidden, cfg.moe_experts, cfg.moe_capacity_factor,
                                     cfg.use_swiglu, cfg.moe_axis,
                                     keep_aux=not cfg.stacked, device=device,
                                     param_dtype=cfg.params_dtype)
        else:
            if cfg.use_swiglu:
                self.ffn_gate = Linear(d, hidden, **kw)
            self.ffn_up = Linear(d, hidden, **kw)
            self.ffn_down = Linear(hidden, d, **kw)

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.moe_experts > 1:
            return self.moe_ffn(h)
        if self.cfg.use_swiglu:
            h = F.silu(self.ffn_gate(h)) * self.ffn_up(h)
        else:
            h = F.gelu(self.ffn_up(h), approximate="tanh")
        return self.ffn_down(h)

    def forward(self, x: torch.Tensor, c: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
        cfg = self.cfg
        norm = lambda h: _affine_free_norm(h, cfg.use_rmsnorm)  # noqa: E731
        sh_a, sc_a, gate_a, sh_m, sc_m, gate_m = self.adaln(F.silu(c)).chunk(6, dim=-1)

        h = modulate(norm(x), sh_a, sc_a)
        b, n, d = h.shape
        nh = cfg.num_heads
        hd = d // nh
        q, k, v = self.qkv(h).reshape(b, n, 3 * nh, hd).split(nh, dim=2)
        if cfg.use_rope:
            q = apply_rope2d(q, *grid, "standard")
            k = apply_rope2d(k, *grid, "standard")
        attn = core_attention(q, k, v, hd ** -0.5, cfg.attention_impl)
        x = x + gate_a[:, None] * self.proj(attn.reshape(b, n, d))

        h = modulate(norm(x), sh_m, sc_m)
        return x + gate_m[:, None] * self._ffn(h)


class DiT(nn.Module):
    """Diffusion transformer over latent grids: forward(z_t [B, h, w, C], t
    [B] in [0, 1], labels [B]) -> velocity [B, h, w, C] in fp32.

    ``grid`` (the latent grid's side, or (rows, cols): the JAX
    ``init_dit_params``' grid) sizes the learned ``pos_embed`` of a model
    without RoPE; with RoPE the same weights run at any grid."""

    def __init__(self, cfg: DiTConfig, grid: int | tuple[int, int] = 16, *, device=None):
        super().__init__()
        if cfg.attention_impl not in IMPLS:
            raise ValueError(f"unknown attention impl {cfg.attention_impl!r}; one of {IMPLS}")
        self.config = cfg
        d, p = cfg.hidden_dim, cfg.patch_size
        kw = dict(device=device, dtype=cfg.params_dtype)
        self.patch_embed = Conv2d(cfg.in_channels, d, p, stride=p, **kw)
        if not cfg.use_rope:
            gh, gw = (grid, grid) if isinstance(grid, int) else grid
            self.pos_embed = nn.Parameter(torch.empty((gh // p) * (gw // p), d, **kw))
        self.t_embed = TimestepEmbedder(d, device=device, param_dtype=cfg.params_dtype)
        self.y_embed = LabelEmbedder(cfg.num_classes, d, cfg.class_dropout, device=device,
                                     param_dtype=cfg.params_dtype)
        if cfg.stacked:
            self.blocks = BlockStack(DiTBlock, {"cfg": cfg}, cfg.depth, path="block",
                                     device=device)
        else:
            for i in range(cfg.depth):
                self.add_module(f"block{i}", DiTBlock(cfg, device=device))
        out_ch = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        self.adaln_out = Linear(d, 2 * d, **kw)
        self.head = Linear(d, p * p * out_ch, **kw)

    def unrolled_blocks(self) -> list[DiTBlock]:
        """The blocks of the unrolled layout, in order."""
        return [getattr(self, f"block{i}") for i in range(self.config.depth)]

    def forward(self, z: torch.Tensor, t: torch.Tensor, labels: torch.Tensor,
                deterministic: bool = True, generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """``generator`` draws the label dropout of a call with
        ``deterministic=False``; ``rows`` = (first, total): these inputs are
        rows of a batch of ``total`` (a data rank's), whose label draws are
        made whole and sliced (the rank's share of the one-process draws) and
        whose pipeline microbatches are the whole batch's
        (``parallel.pipeline.microbatch_rows``)."""
        cfg = self.config
        dt = cfg.compute_dtype
        b, h, w, c = z.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"latent grid {h}x{w} is not a multiple of patch {p}")
        gh, gw = h // p, w // p

        # Patchify: a stride-p conv is the linear patch embedding.
        x = self.patch_embed(z.permute(0, 3, 1, 2).to(dt))
        x = x.flatten(2).transpose(1, 2)
        if not cfg.use_rope:
            x = x + self.pos_embed.to(dt)[None]

        cond = self.t_embed(t, dt) + self.y_embed(labels, deterministic, generator,
                                                  rows).to(dt)
        if not cfg.stacked:
            for block in self.unrolled_blocks():
                x = block(x, cond, (gh, gw))
        elif (pipe := ambient(cfg.pipeline_axis)) is not None:
            from ..parallel.pipeline import pipeline_apply

            run = functools.partial(_block_slice, self.blocks.template, (gh, gw))
            x = pipeline_apply(run, self.blocks.stacks(), x, cond, group=pipe.group,
                               num_microbatches=cfg.pipeline_microbatches, rows=rows)
        else:
            x = self.blocks(x, cond, (gh, gw))

        # Final adaLN and linear head, zero-init (DiT's final layer).
        shift, scale = self.adaln_out(F.silu(cond)).chunk(2, dim=-1)
        out = self.head(modulate(_affine_free_norm(x, cfg.use_rmsnorm), shift, scale))
        # Unpatchify [B, gh*gw, p*p*C] (rows ordered p_row, p_col, C).
        out_ch = out.shape[-1] // (p * p)
        out = out.reshape(b, gh, gw, p, p, out_ch).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, out_ch).float()


def _block_slice(block: DiTBlock, grid: tuple[int, int], params: dict, x: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor:
    """``block`` on one slice's tensors of the stacked layout."""
    return functional_call(block, params, (x, cond, grid))


_UNROLLED = re.compile(r"^block(\d+)\.(.*)$")
_STACKED = "blocks.block."


def is_stacked_dit(sd) -> bool:
    """Whether a DiT state_dict holds the stacked layout."""
    return any(k.startswith(_STACKED) for k in sd)


def stack_dit_params(sd, depth: int) -> dict:
    """An unrolled DiT state_dict (``block{i}.<path>``, tensors or numpy
    arrays) in the stacked layout (``blocks.block.<path>`` [depth, ...]), in
    the place of block 0's keys; a new dict."""
    from ..ops.stack import _stack

    parts: dict[str, list] = {}
    out = {}
    for k, v in sd.items():
        hit = _UNROLLED.match(k)
        if hit is None:
            out[k] = v
            continue
        rest = hit.group(2)
        if rest not in parts:
            parts[rest] = [None] * depth
            out[_STACKED + rest] = None
        parts[rest][int(hit.group(1))] = v
    for rest, vs in parts.items():
        if any(v is None for v in vs):
            raise KeyError(f"{rest} is missing in some of the {depth} blocks")
        out[_STACKED + rest] = _stack(vs)
    return out


def unstack_dit_params(sd) -> dict:
    """Inverse of :func:`stack_dit_params`: each ``blocks.block.<path>``
    split into ``block{i}.<path>`` (views of its slices), in block order."""
    stacked = {k[len(_STACKED):]: v for k, v in sd.items() if k.startswith(_STACKED)}
    out = {}
    for k, v in sd.items():
        if not k.startswith(_STACKED):
            out[k] = v
        elif k[len(_STACKED):] == next(iter(stacked)):
            depth = len(v)
            out.update({f"block{i}.{rest}": s[i] for i in range(depth)
                        for rest, s in stacked.items()})
    return out


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """Flax's default kernel init: variance_scaling(1, 'fan_in',
    'truncated_normal'), cut at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _init_module(m: nn.Module, zero: set, small: set, generator) -> None:
    """The JAX initializer of one module (see :func:`init_dit_weights`); an
    expert weight held in part is drawn whole and sliced."""
    if m in zero:
        m.weight.zero_()
    elif m in small:
        nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
    elif isinstance(m, (nn.Linear, nn.Conv2d)):
        _lecun_normal_(m.weight, m.weight[0].numel(), generator)
    elif isinstance(m, ExpertLinear):  # fan_in per expert
        w = m.weight
        if m.total is not None and m.total != w.shape[0]:
            w = w.new_empty((m.total,) + tuple(w.shape[1:]))
        _lecun_normal_(w, w.shape[-1], generator)
        if w is not m.weight:
            m.weight.copy_(w[m.first:m.first + m.weight.shape[0]])
    else:
        return
    if getattr(m, "bias", None) is not None:
        m.bias.zero_()


@torch.no_grad()
def init_dit_weights(model: DiT, generator: torch.Generator | None = None) -> DiT:
    """The JAX initializers (their distributions, not their draws): adaLN,
    ``adaln_out`` and ``head`` zero, ``qkv`` and ``proj`` truncated
    normal(0.02), the label table and ``pos_embed`` normal(0.02), every
    other kernel Flax's lecun normal; biases zero. A model placed by
    ``PipelinePlacement.shard`` gets the whole model's values: the stacked
    layout draws each block whole into a throwaway block and keeps what
    it holds (its stage's slices, its experts), and an unrolled block's
    expert weight held in part is drawn whole."""
    cfg = model.config
    device = model.head.weight.device
    for child in model._modules.values():
        if isinstance(child, BlockStack):
            _init_stack(child, cfg, device, generator)
            continue
        zero = {model.adaln_out, model.head}
        small = set()
        if isinstance(child, DiTBlock):
            zero.add(child.adaln)
            small = {child.qkv, child.proj}
        for m in child.modules():
            _init_module(m, zero, small, generator)
    model.y_embed.embedding.normal_(0.0, 0.02, generator=generator)
    if not cfg.use_rope:
        model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model


def _init_stack(stack: BlockStack, cfg: DiTConfig, device, generator) -> None:
    """Block j's draws of the unrolled model, one block at a time, into
    slice j of the stacks where this module holds it (a pipeline stage's
    slices; a held expert range on the experts' axis, 1 of a stack)."""
    held = stack.held
    lo, hi = stack.template.moe_ffn.held if cfg.moe_experts > 1 else (0, 0)
    stacks = stack.stacks()
    for j in range(cfg.depth):
        with torch.device("meta"):
            block = DiTBlock(cfg)
        block = block.to_empty(device=device)
        for m in block.modules():
            _init_module(m, {block.adaln}, {block.qkv, block.proj}, generator)
        if j not in held:
            continue
        for name, t in block.state_dict().items():
            if ".experts." in name:
                t = t[lo:hi]
            stacks[name][j - held.start].copy_(t)


@torch.no_grad()
def perturb_zero_init(model: DiT, seed: int, std: float = 0.02) -> DiT:
    """N(0, std^2) in the weights the JAX init zeroes (every block's adaLN,
    ``adaln_out``, ``head``), so that every block shapes the output (at the
    init the blocks start as the identity and the head at 0, and a loss
    does not see them). Each weight is drawn from a generator seeded from
    (seed, its unrolled name), so a pipeline stage draws the whole model's
    values and a stacked model the unrolled one's."""
    def draw(p, name):
        gen = torch.Generator(device=p.device).manual_seed(
            seed * 1_000_003 + zlib.crc32(name.encode()))
        p.normal_(0.0, std, generator=gen)

    for name, p in model.named_parameters():
        if not name.endswith(("adaln.weight", "adaln_out.weight", "head.weight")):
            continue
        if name.startswith(_STACKED):  # slice j as the unrolled block{j}'s
            held = model.blocks.held
            for j in held:
                draw(p[j - held.start], f"block{j}.{name[len(_STACKED):]}")
        else:
            draw(p, name)
    return model


def create_dit(cfg: DiTConfig, grid: int | tuple[int, int] = 16, *, device=None,
               seed: int | None = 0, placement=None) -> DiT:
    """A DiT on ``device`` (default CUDA) with weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device (``seed=None``
    leaves them uninitialised, for a checkpoint load). ``placement`` (a
    ``parallel.PipelinePlacement``): only this rank's blocks and experts
    are allocated, with the whole model's values."""
    from .transvae import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        model = DiT(cfg, grid)
    if placement is not None:
        placement.shard(model)
    model = model.to_empty(device=device)
    if seed is not None:
        init_dit_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model
