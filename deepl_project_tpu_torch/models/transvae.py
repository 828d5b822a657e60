"""TransVAE: hybrid CNN+Transformer VAE (PyTorch port of
``models/transvae.py``), NCHW.

encode -> conv_mu / conv_logvar 3x3 heads; ``forward`` clamps mu to
+-mu_clip and logvar to logvar_clip and decodes either the mean
(``sample=False``, the serving and evaluation path) or a sample of the
posterior (``sample=True``, training; see :meth:`TransVAE.reparameterize`).
The decoder emits unbounded logits.

The module tree and state_dict keys are the reference's (the mapping of the
JAX package's ``utils/convert.py``), so a reference-layout checkpoint loads
with ``load_state_dict(strict=True)``. ``quant='int8'`` builds the int8
serving tree as the JAX config does (``quant_scope``: the ResBlocks, the
ConvFFNs or both); ``quantize.quantize_model`` fills it from a float model.
``remat`` (see :func:`enable_gradient_checkpointing`) checkpoints each block
in training; ``dropout`` acts only in a call with ``deterministic=False``,
which the training steps never make (as in the JAX package).

``context_axis`` ('context'): under an ambient context group
(``parallel.context.context_parallel(mesh)``) the model takes each image's
rows of this rank (``parallel.shard_rows``) and computes its rows of the
whole image's result, as the JAX model does under a mesh that shards rows
over that axis; with no ambient group the field changes nothing. It takes
every height the JAX package takes: any multiple of the context size and
the downsample factor. A map deeper in is split by its own height
(``parallel.context.row_split``), unevenly where the context size does not
divide it (720 px over 2 ranks: 23 / 22 rows of stage 4's 45), as GSPMD
pads it. A model
without the field refuses to run under an ambient group. An int8 model
(``quant='int8'``) runs under the group as the float one does: its convs
exchange halo rows of their float input before they quantize.

``scan_blocks``: each stage's blocks are one ``ops.stack.BlockStack``, the
JAX package's stacked layout (``stages.{i}.scan.block.*`` with a leading
depth axis; ``ops.stack.to_scanned_params`` / ``from_scanned_params``
convert state_dicts). The forward, the gradients and the seeded init are the
unrolled model's, bit for bit, also under an ambient context group (the
halo convs, GroupNorm moments, RoPE rows and the ring run inside the
stack's iterations, and a checkpointed iteration's recompute runs under
the same group) and on a mesh (``parallel.shard_params``: FSDP gathers a
stack whole once a forward, tensor parallelism splits every slice). Int8
is refused, as in JAX.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..config import TransVAEConfig, get_config
from ..ops.layers import (Conv2d, init_conv_, init_linear_, init_small_conv_)
from ..ops.norms import GroupNorm, gn_groups
from ..ops.stack import BlockStack
from ..parallel import context as cp
from .decoder import TransVAEDecoder
from .encoder import TransVAEEncoder


class TransVAE(nn.Module):
    def __init__(self, cfg: TransVAEConfig, *, device=None):
        super().__init__()
        if cfg.quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {cfg.quant!r}")
        if cfg.quant and cfg.scan_blocks:
            # The JAX package's refusal (quantize.quantize_model).
            raise ValueError("quant='int8' does not support scan_blocks param "
                             "layouts; rebuild the checkpoint with "
                             "scan_blocks=False (ops/stack.py converters).")
        self.config = cfg
        self.encoder = TransVAEEncoder(cfg, device=device)
        self.decoder = TransVAEDecoder(cfg, device=device)
        final = cfg.base_dims[-1]
        pkw = dict(device=device, dtype=cfg.params_dtype)
        self.conv_mu = Conv2d(final, cfg.latent_dim, 3, padding=1, **pkw)
        self.conv_logvar = Conv2d(final, cfg.latent_dim, 3, padding=1, **pkw)
        self.latent_norm = (GroupNorm(gn_groups(final), final, **pkw)
                            if cfg.norm_latents else None)

    def _context(self, x: torch.Tensor | None = None, image: bool = False):
        """The ambient context state for this model (None without one),
        with the global height of the map ``x`` (this rank's rows) entered
        (``ContextState.for_map``; kept where a call of this model already
        entered its input); raises where the model cannot run under it.
        ``image``: ``x`` is the input, whose height JAX's placement refuses
        unless the context size and the downsample factor divide it."""
        state = cp.current()
        if state is None:
            return None
        cfg = self.config
        if cfg.context_axis is None:
            raise ValueError("an ambient context group shards the rows, but this model's "
                             "config leaves context_axis unset: build it with "
                             "context_axis='context'")
        if state.height is not None or x is None:
            return state
        f = 2 ** (cfg.num_stages - 1)

        def refuse(rows):
            raise ValueError(
                f"an image of {rows} rows does not split over the context axis of "
                f"{state.size} ranks or the downsample factor {f}: use a height that is a "
                f"multiple of both (the JAX package refuses it too)")

        # The input splits evenly (JAX's placement): its height is this
        # rank's rows times C, which the downsample factor must divide.
        if image and (x.shape[2] * state.size) % f:
            refuse(x.shape[2] * state.size)
        state = state.for_map(x)
        if image and state.height % state.size:
            refuse(state.height)
        return state

    def encode(self, x: torch.Tensor, deterministic: bool = True):
        """x [B, C, H, W] -> (mu, logvar), each [B, D, H/f, W/f], unclamped."""
        with cp.use(self._context(x, image=True)):
            h = self.encoder(x, deterministic)
            if self.latent_norm is not None:
                h = self.latent_norm(h)
            return self.conv_mu(h), self.conv_logvar(h)

    def decode(self, z: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """z [B, D, h, w] -> logits [B, C, h*f, w*f]."""
        with cp.use(self._context(z)):
            return self.decoder(z, deterministic)

    def reparameterize(self, mu: torch.Tensor, logvar: torch.Tensor,
                       generator: torch.Generator | None = None,
                       eps: torch.Tensor | None = None,
                       noise_rows: tuple[int, int] | None = None) -> torch.Tensor:
        """z = mu + eps * exp(0.5 * logvar) in fp32 with logvar clamped, cast
        back to mu's dtype. ``eps`` is standard normal noise drawn from
        ``generator`` unless given; the JAX package draws it from its
        'sample' RNG stream, and the two generators never give the same
        numbers, so a test hands both the same ``eps``. ``noise_rows``
        (first, total): the draw is the whole batch's, ``total`` rows, of
        which rows first.. are this batch's (data parallelism: every rank
        draws what a single process would and keeps its own rows). Under an
        ambient context group the draw is the global latent's, its rows H/f
        whole, of which this rank keeps its own (the JAX step's one global
        draw). A given ``eps`` is that global draw too."""
        lo, hi = self.config.logvar_clip
        mu32 = mu.float()
        std = torch.exp(0.5 * logvar.float().clamp(lo, hi))
        state = self._context(mu)
        b, d, h, w = std.shape
        total, first = (b, 0) if noise_rows is None else (noise_rows[1], noise_rows[0])
        height = h if state is None else state.map_rows(mu)
        row = 0 if state is None else state.row_range(height)[0]
        if eps is None:
            eps = torch.randn((total, d, height, w), generator=generator, device=std.device,
                              dtype=torch.float32)
        eps = eps[first:first + b, :, row:row + h]
        return (mu32 + eps.to(std.device) * std).to(mu.dtype)

    def forward(self, x: torch.Tensor, sample: bool = False,
                generator: torch.Generator | None = None, deterministic: bool = True,
                noise_rows: tuple[int, int] | None = None, eps: torch.Tensor | None = None):
        """(reconstruction logits, mu, logvar) with mu and logvar clamped;
        decodes the clamped mean, or with ``sample=True`` a sample of the
        posterior drawn with ``generator`` (``noise_rows``, ``eps``: see
        :meth:`reparameterize`). ``deterministic=False`` turns the config's
        dropout on."""
        cfg = self.config
        with cp.use(self._context(x, image=True)):
            mu, logvar = self.encode(x, deterministic)
            mu = mu.clamp(-cfg.mu_clip, cfg.mu_clip)
            logvar = logvar.clamp(*cfg.logvar_clip)
            z = (self.reparameterize(mu, logvar, generator, eps, noise_rows)
                 if sample else mu)
            return self.decode(z, deterministic), mu, logvar


def _unrolled_modules(module: nn.Module):
    """``module.modules()``, with each BlockStack's descendants replaced by
    those of its blocks in order (``BlockStack.unrolled``: views of the
    stacks' slices): the unrolled model's module order."""
    yield module
    for child in module.children():
        if isinstance(child, BlockStack):
            for j in range(child.depth):
                yield from child.unrolled(j).modules()
        else:
            yield from _unrolled_modules(child)


@torch.no_grad()
def init_weights(model: TransVAE, generator: torch.Generator | None = None) -> TransVAE:
    """The JAX package's initializers: Kaiming fan-out normal convs,
    truncated-normal(0.02) linears, unit norm scales, zero biases, and a
    small-variance init of the latent heads. A ``scan_blocks`` model takes
    the draws of the unrolled model from the same generator, slice j of a
    stack those of block j."""
    for m in _unrolled_modules(model):
        if isinstance(m, nn.Linear):
            init_linear_(m, generator)
        elif isinstance(m, nn.Conv2d):
            if m is model.conv_mu or m is model.conv_logvar:
                init_small_conv_(m, generator)
            else:
                init_conv_(m, generator)
        elif hasattr(m, "weight") and isinstance(m.weight, nn.Parameter):
            m.weight.fill_(1.0)  # RMSNorm / LayerNorm / GroupNorm
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return model


def resolve_device(device=None) -> torch.device:
    """The entry points' device: CUDA unless the caller names another;
    raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepl_project_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return device


def create_transvae(variant: str = "large", compression_ratio: int = 16,
                    latent_dim: int | None = None, *, device=None,
                    seed: int | None = 0, **kw) -> TransVAE:
    """Build a TransVAE on ``device`` (default CUDA) with weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device (``seed=None``
    leaves the parameters uninitialised, for a checkpoint load)."""
    device = resolve_device(device)
    cfg = get_config(variant, compression_ratio, latent_dim, **kw)
    with torch.device("meta"):
        model = TransVAE(cfg)
    model = model.to_empty(device=device)
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        init_weights(model, gen)
    return model.eval()


def from_pretrained(model_name: str, checkpoint_dir: str | None = None, device=None,
                    **kw) -> TransVAE:
    """A model by name, ``transvae-<variant>-f<f>d<d>`` (the reference's
    names), built from the name and ``kw`` as ``create_transvae`` builds it.

    Its weights come from a local registry, not a download: an explicit
    ``checkpoint_dir`` first; else ``$DEEPL_PRETRAINED_DIR/<model_name>``
    where that directory exists; each a checkpoint directory of the port's
    trainer (``training/checkpoint.py``; its EMA parameters where it has
    them, as the JAX package restores; a ``scan_blocks`` checkpoint loads into
    an unrolled model and back, ``utils.convert.in_model_layout``). Without
    either the weights are random, drawn from seed 0. On ``device`` (default
    CUDA), in eval mode."""
    parts = model_name.split("-")
    if len(parts) < 3:
        raise ValueError(f"Bad model name {model_name!r}; want transvae-<variant>-f<f>d<d>")
    variant, fd = parts[1], parts[2]
    f = int(fd[1:].split("d")[0])
    d = int(fd.split("d")[1])
    if checkpoint_dir is None:
        registry = os.environ.get("DEEPL_PRETRAINED_DIR")
        if registry and os.path.isdir(os.path.join(registry, model_name)):
            checkpoint_dir = os.path.join(registry, model_name)
    model = create_transvae(variant, f, d, device=device,
                            seed=0 if checkpoint_dir is None else None, **kw)
    if checkpoint_dir is not None:
        from ..training.checkpoint import restore_model_params
        from ..utils.convert import in_model_layout

        device = next(model.parameters()).device
        saved = restore_model_params(checkpoint_dir, map_location=device)
        model.load_state_dict(in_model_layout(model, saved), strict=True)
    return model


def enable_gradient_checkpointing(model: TransVAE, policy: str | None = None) -> TransVAE:
    """A TransVAE with per-block gradient checkpointing (``remat=True``) on
    the same parameter and buffer tensors as ``model``: the counterpart of
    the JAX package's ``enable_gradient_checkpointing``, which returns a new
    module for the same params. ``policy`` overrides ``remat_policy``
    ('none', 'dots', 'dots_all', 'conv_dots'; see
    ``ops.blocks.resolve_remat_policy``)."""
    kw = {"remat": True}
    if policy is not None:
        kw["remat_policy"] = policy
    with torch.device("meta"):
        out = TransVAE(model.config.replace(**kw))
    out.load_state_dict(model.state_dict(keep_vars=True), strict=True, assign=True)
    return out.train(model.training)


def get_last_layer(model: TransVAE) -> torch.Tensor:
    """The decoder's final conv weight: the layer the adaptive GAN weight
    differentiates against."""
    return model.decoder.conv_out.weight


def adaptive_gan_weight(rec_grad: torch.Tensor, gan_grad: torch.Tensor,
                        max_weight: float = 1e4) -> torch.Tensor:
    """VQGAN's adaptive weight ||grad_last L_rec|| / (||grad_last L_gan|| +
    1e-4), clamped to [0, max_weight] and detached: it balances the
    adversarial term against the reconstruction losses."""
    weight = torch.linalg.vector_norm(rec_grad.float()) / (
        torch.linalg.vector_norm(gan_grad.float()) + 1e-4)
    return weight.clamp(0.0, max_weight).detach()


def count_params(model: nn.Module) -> dict:
    """Parameter counts: total, encoder, decoder (works on a meta model)."""
    def _count(m):
        return sum(p.numel() for p in m.parameters())
    return {"total": _count(model), "encoder": _count(model.encoder),
            "decoder": _count(model.decoder)}
