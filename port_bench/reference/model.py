"""Plain TransVAE forward in float32: the yardstick the served and trained
paths are held to.

Written from the published architecture (the reference repository's
``transvae`` modules and the ICLR 2026 TransVAE paper), over a flat state
dict whose keys are the reference repository's. It imports nothing of the
measured package and takes none of its derived tensors: every weight is read
as it was made (no folded ConvFFN, no fused resample convs, no packed
attention operands).

Departures from the reference repository, each on purpose:

- GELU is the exact erf form everywhere (the reference's ``nn.GELU()``);
  the measured package takes the tanh form in bfloat16.
- Attention is computed in query blocks (``ATTN_BLOCK`` rows) so that the
  float32 logits of N = 4096 or 16384 tokens fit; the sums are the same.
- ``precision='fp8'`` keeps the inputs and the output of every
  convolution and product in float8 e4m3 (one absmax scale a tensor, a
  straight-through gradient), as the bfloat16 program keeps them in
  bfloat16, and accumulates in float32: the control that a lower precision
  than the configuration's must fail.

The module tree, as state-dict keys (``param_spec`` lists them all):
``encoder.conv_in``, ``encoder.stages.{i}.{j}`` (ResBlocks: ``norm1``,
``conv1``, ``norm2``, ``conv2``; TransVAE blocks: ``norm1``, ``attn.{norm_q,
norm_k, norm_v, to_q, to_k, to_v, proj}``, ``norm2``, ``ffn.{proj_in,
conv.0, conv.2, conv.4, proj_out}``), ``encoder.downsamples.{i}.{main_path.0,
main_path.2, dc_conv}``, ``conv_mu``, ``conv_logvar``, ``decoder.conv_in``,
``decoder.stages.{i}.{j}``, ``decoder.upsamples.{i}.{main_path.1,
main_path.3, dc_conv}``, ``decoder.norm_out``, ``decoder.conv_out``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ATTN_BLOCK = 1024
GN_GROUPS = 32
GN_EPS = 1e-5
LN_EPS = 1e-5
RMS_EPS = 1e-6
ROPE_BASE = 10000.0


def strict_fp32() -> None:
    """Full float32 products on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the parameters ---------------------------------------------------------

def _stage_kinds(cfg: dict) -> list[str]:
    n = len(cfg["depths"])
    return ["cnn" if i < cfg["num_cnn_stages"] else "transformer" for i in range(n)]


def _resblock(prefix: str, c: int) -> list:
    return [(f"{prefix}.norm1.weight", (c,), "norm"), (f"{prefix}.norm1.bias", (c,), "bias"),
            (f"{prefix}.conv1.weight", (c, c, 3, 3), "conv"), (f"{prefix}.conv1.bias", (c,), "bias"),
            (f"{prefix}.norm2.weight", (c,), "norm"), (f"{prefix}.norm2.bias", (c,), "bias"),
            (f"{prefix}.conv2.weight", (c, c, 3, 3), "conv"), (f"{prefix}.conv2.bias", (c,), "bias")]


def _tblock(prefix: str, c: int, mlp_ratio: float) -> list:
    hidden, ch = int(c * mlp_ratio * 4), int(c * mlp_ratio)
    out = [(f"{prefix}.norm1.weight", (c,), "norm")]
    for n in ("norm_q", "norm_k", "norm_v"):
        out += [(f"{prefix}.attn.{n}.weight", (c,), "norm"),
                (f"{prefix}.attn.{n}.bias", (c,), "bias")]
    for n in ("to_q", "to_k", "to_v"):
        out.append((f"{prefix}.attn.{n}.weight", (c, c), "linear"))
    out += [(f"{prefix}.attn.proj.weight", (c, c), "linear"),
            (f"{prefix}.attn.proj.bias", (c,), "bias"),
            (f"{prefix}.norm2.weight", (c,), "norm"),
            (f"{prefix}.ffn.proj_in.weight", (hidden, c), "linear"),
            (f"{prefix}.ffn.proj_in.bias", (hidden,), "bias"),
            (f"{prefix}.ffn.conv.0.weight", (ch, hidden, 1, 1), "conv"),
            (f"{prefix}.ffn.conv.0.bias", (ch,), "bias"),
            (f"{prefix}.ffn.conv.2.weight", (ch, ch, 3, 3), "conv"),
            (f"{prefix}.ffn.conv.2.bias", (ch,), "bias"),
            (f"{prefix}.ffn.conv.4.weight", (hidden, ch, 1, 1), "conv"),
            (f"{prefix}.ffn.conv.4.bias", (hidden,), "bias"),
            (f"{prefix}.ffn.proj_out.weight", (c, hidden), "linear"),
            (f"{prefix}.ffn.proj_out.bias", (c,), "bias")]
    return out


def _conv(name: str, cout: int, cin: int, k: int, kind: str = "conv") -> list:
    return [(f"{name}.weight", (cout, cin, k, k), kind), (f"{name}.bias", (cout,), "bias")]


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(state-dict key, shape, init kind) of every parameter, in the
    reference module order. Kinds: 'conv', 'linear', 'mu_head',
    'logvar_head', 'norm' (a norm's scale), 'bias'."""
    dims, depths, n = cfg["base_dims"], cfg["depths"], len(cfg["depths"])
    kinds, mlp = _stage_kinds(cfg), cfg["mlp_ratio"]
    spec = _conv("encoder.conv_in", dims[0], cfg["input_channels"], 3)
    for i in range(n):
        for j in range(depths[i]):
            p = f"encoder.stages.{i}.{j}"
            spec += _resblock(p, dims[i]) if kinds[i] == "cnn" else _tblock(p, dims[i], mlp)
    for i in range(n - 1):
        p = f"encoder.downsamples.{i}"
        spec += (_conv(f"{p}.main_path.0", dims[i], dims[i], 3)
                 + _conv(f"{p}.main_path.2", dims[i + 1], dims[i], 3)
                 + _conv(f"{p}.dc_conv", dims[i + 1], 4 * dims[i], 1))
    d = cfg["latent_dim"]
    spec += _conv("conv_mu", d, dims[-1], 3, "mu_head") + _conv("conv_logvar", d, dims[-1], 3,
                                                                "logvar_head")
    rdims, rdepths, rkinds = dims[::-1], depths[::-1], kinds[::-1]
    spec += _conv("decoder.conv_in", rdims[0], d, 3)
    for i in range(n):
        for j in range(rdepths[i]):
            p = f"decoder.stages.{i}.{j}"
            spec += _resblock(p, rdims[i]) if rkinds[i] == "cnn" else _tblock(p, rdims[i], mlp)
    for i in range(n - 1):
        p = f"decoder.upsamples.{i}"
        spec += (_conv(f"{p}.main_path.1", rdims[i + 1], rdims[i], 3)
                 + _conv(f"{p}.main_path.3", rdims[i + 1], rdims[i + 1], 3)
                 + _conv(f"{p}.dc_conv", 4 * rdims[i + 1], rdims[i], 1))
    spec += [("decoder.norm_out.weight", (rdims[-1],), "norm"),
             ("decoder.norm_out.bias", (rdims[-1],), "bias")]
    spec += _conv("decoder.conv_out", cfg["input_channels"], rdims[-1], 3)
    return spec


# -- operations ---------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one absmax scale, straight-through."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


class Ops:
    """The products of one forward at a precision ('fp32' or 'fp8')."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
        self.low = precision == "fp8"

    def _q(self, t):
        return _fp8(t) if self.low else t

    def conv(self, x, p, name, stride=1, padding=None):
        w = p[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        return self._q(F.conv2d(self._q(x), self._q(w), p[f"{name}.bias"], stride=stride,
                                padding=pad))

    def linear(self, x, p, name, bias=True):
        return self._q(F.linear(self._q(x), self._q(p[f"{name}.weight"]),
                                p[f"{name}.bias"] if bias else None))

    def bmm(self, a, b):
        return self._q(torch.matmul(self._q(a), self._q(b)))


def group_norm(x, p, name):
    return F.group_norm(x, GN_GROUPS, p[f"{name}.weight"], p[f"{name}.bias"], GN_EPS)


def rms_norm(x, p, name):
    rms = torch.sqrt(x.square().mean(dim=1, keepdim=True) + RMS_EPS)
    return x / rms * p[f"{name}.weight"][:, None, None]


def layer_norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def rope_angles(head_dim: int, height: int, width: int, device):
    """(angle_a, angle_b), each [H*W, head_dim/2] float64: the reference's
    axial table [y, y, x, x] of head_dim entries, split into its even (a)
    and odd (b) entries. The first output of a pair rotates by a, the second
    takes b's sine and cosine (the reference's pairing)."""
    half = head_dim // 2
    inv = 1.0 / (ROPE_BASE ** (torch.arange(0, half, 2, dtype=torch.float64) / half))
    ys = torch.arange(height, dtype=torch.float64).repeat_interleave(width)
    xs = torch.arange(width, dtype=torch.float64).repeat(height)
    fy, fx = ys[:, None] * inv, xs[:, None] * inv
    table = torch.cat([fy, fy, fx, fx], dim=-1)
    return table[:, 0::2].to(device), table[:, 1::2].to(device)


def apply_rope(t, angles):
    """t [B, heads, N, d] float32."""
    a, b = (x.float()[None, None] for x in angles)
    t1, t2 = t[..., 0::2], t[..., 1::2]
    out1 = t1 * torch.cos(a) - t2 * torch.sin(a)
    out2 = t1 * torch.sin(b) + t2 * torch.cos(b)
    return torch.stack([out1, out2], dim=-1).flatten(-2)


def attention(ops, x, p, name, head_dim):
    """Global self-attention on an NCHW map: LayerNorm'd Q/K/V, 2D RoPE,
    softmax at head_dim**-0.5, projection with bias."""
    b, c, h, w = x.shape
    n, heads = h * w, c // head_dim
    xf = x.permute(0, 2, 3, 1).reshape(b, n, c)

    def proj(which):
        t = ops.linear(layer_norm(xf, p, f"{name}.norm_{which}"), p, f"{name}.to_{which}",
                       bias=False)
        return t.reshape(b, n, heads, head_dim).transpose(1, 2)

    q, k, v = proj("q"), proj("k"), proj("v")
    angles = rope_angles(head_dim, h, w, x.device)
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    scale = head_dim ** -0.5
    out = []
    for r in range(0, n, ATTN_BLOCK):
        logits = ops.bmm(q[:, :, r:r + ATTN_BLOCK], k.transpose(-1, -2)) * scale
        out.append(ops.bmm(torch.softmax(logits, dim=-1), v))
    o = torch.cat(out, dim=2).transpose(1, 2).reshape(b, n, c)
    o = ops.linear(o, p, f"{name}.proj")
    return o.reshape(b, h, w, c).permute(0, 3, 1, 2)


def conv_ffn(ops, x, p, name):
    """proj_in -> GELU, then y + (1x1 -> GELU -> 3x3 -> GELU -> 1x1)(y),
    then proj_out."""
    y = F.gelu(ops.linear(x.permute(0, 2, 3, 1), p, f"{name}.proj_in")).permute(0, 3, 1, 2)
    z = F.gelu(ops.conv(y, p, f"{name}.conv.0"))
    z = F.gelu(ops.conv(z, p, f"{name}.conv.2"))
    y = y + ops.conv(z, p, f"{name}.conv.4")
    return ops.linear(y.permute(0, 2, 3, 1), p, f"{name}.proj_out").permute(0, 3, 1, 2)


def resblock(ops, x, p, name):
    h = ops.conv(F.silu(group_norm(x, p, f"{name}.norm1")), p, f"{name}.conv1")
    h = ops.conv(F.silu(group_norm(h, p, f"{name}.norm2")), p, f"{name}.conv2")
    return x + h


def transvae_block(ops, x, p, name, head_dim):
    x = x + attention(ops, rms_norm(x, p, f"{name}.norm1"), p, f"{name}.attn", head_dim)
    return x + conv_ffn(ops, rms_norm(x, p, f"{name}.norm2"), p, f"{name}.ffn")


def downsample(ops, x, p, name):
    y = ops.conv(F.silu(ops.conv(x, p, f"{name}.main_path.0")), p, f"{name}.main_path.2",
                 stride=2, padding=1)
    return y + ops.conv(F.pixel_unshuffle(x, 2), p, f"{name}.dc_conv")


def upsample(ops, x, p, name):
    y = F.interpolate(x, scale_factor=2, mode="nearest")
    y = ops.conv(F.silu(ops.conv(y, p, f"{name}.main_path.1")), p, f"{name}.main_path.3")
    return y + F.pixel_shuffle(ops.conv(x, p, f"{name}.dc_conv"), 2)


def _stages(ops, h, p, cfg, side, kinds, depths, resample):
    for i, kind in enumerate(kinds):
        for j in range(depths[i]):
            name = f"{side}.stages.{i}.{j}"
            h = (resblock(ops, h, p, name) if kind == "cnn"
                 else transvae_block(ops, h, p, name, cfg["head_dim"]))
        if i < len(kinds) - 1:
            h = resample(ops, h, p, f"{side}.{'downsamples' if side == 'encoder' else 'upsamples'}.{i}")
    return h


def encode(cfg, p, x, ops=None):
    """x [B, 3, H, W] float32 in [0, 1] -> (mu, logvar), unclamped."""
    ops = ops or Ops()
    h = ops.conv(x, p, "encoder.conv_in")
    h = _stages(ops, h, p, cfg, "encoder", _stage_kinds(cfg), cfg["depths"], downsample)
    return ops.conv(h, p, "conv_mu"), ops.conv(h, p, "conv_logvar")


def decode(cfg, p, z, ops=None):
    """z [B, D, h, w] -> logits [B, 3, H, W]."""
    ops = ops or Ops()
    h = ops.conv(z, p, "decoder.conv_in")
    h = _stages(ops, h, p, cfg, "decoder", _stage_kinds(cfg)[::-1], cfg["depths"][::-1],
                upsample)
    return ops.conv(F.silu(group_norm(h, p, "decoder.norm_out")), p, "decoder.conv_out")


def forward(cfg, p, x, eps=None, ops=None):
    """(logits, mu, logvar), mu and logvar clamped; decodes the mean, or
    with ``eps`` (standard normal, the latent's shape) the sample
    mu + eps * exp(logvar / 2)."""
    mu, logvar = encode(cfg, p, x, ops)
    mu = mu.clamp(-cfg["mu_clip"], cfg["mu_clip"])
    logvar = logvar.clamp(*cfg["logvar_clip"])
    z = mu if eps is None else mu + eps * torch.exp(0.5 * logvar)
    return decode(cfg, p, z, ops), mu, logvar


@torch.no_grad()
def reconstruct(cfg, p, images_nhwc_uint8: torch.Tensor, block: int, precision="fp32"):
    """sigmoid(decode(mu)) in [0, 1], [B, H, W, 3] float32, from uint8
    images, ``block`` images at a time."""
    ops = Ops(precision)
    out = []
    for i in range(0, images_nhwc_uint8.shape[0], block):
        x = images_nhwc_uint8[i:i + block].permute(0, 3, 1, 2).float() / 255.0
        logits = forward(cfg, p, x, ops=ops)[0]
        out.append(torch.sigmoid(logits).permute(0, 2, 3, 1))
    return torch.cat(out)


def count(cfg) -> int:
    return sum(math.prod(s) for _, s, _ in param_spec(cfg))
