"""TransVAE: hybrid CNN+Transformer VAE (PyTorch port of
``models/transvae.py``), NCHW.

encode -> conv_mu / conv_logvar 3x3 heads; ``forward`` clamps mu to
+-mu_clip and logvar to logvar_clip and decodes the mean (the serving path;
``sample=False``). The decoder emits unbounded logits.

The module tree and state_dict keys are the reference's (the mapping of the
JAX package's ``utils/convert.py``), so a reference-layout checkpoint loads
with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import TransVAEConfig, get_config
from ..ops.layers import (Conv2d, init_conv_, init_linear_, init_small_conv_)
from ..ops.norms import GroupNorm, gn_groups
from .decoder import TransVAEDecoder
from .encoder import TransVAEEncoder

# Config settings of the JAX package whose code paths are not ported yet.
_NOT_PORTED = {
    "remat": False, "remat_resample": False, "scan_blocks": False,
    "context_axis": None, "quant": None, "quant_calibrate": False,
    "dropout": 0.0,
}


class TransVAE(nn.Module):
    def __init__(self, cfg: TransVAEConfig, *, device=None):
        super().__init__()
        for field, ok in _NOT_PORTED.items():
            if getattr(cfg, field) != ok:
                raise NotImplementedError(
                    f"{field}={getattr(cfg, field)!r} is not yet ported to "
                    f"deepl_project_tpu_torch")
        self.config = cfg
        self.encoder = TransVAEEncoder(cfg, device=device)
        self.decoder = TransVAEDecoder(cfg, device=device)
        final = cfg.base_dims[-1]
        pkw = dict(device=device, dtype=cfg.params_dtype)
        self.conv_mu = Conv2d(final, cfg.latent_dim, 3, padding=1, **pkw)
        self.conv_logvar = Conv2d(final, cfg.latent_dim, 3, padding=1, **pkw)
        self.latent_norm = (GroupNorm(gn_groups(final), final, **pkw)
                            if cfg.norm_latents else None)

    def encode(self, x: torch.Tensor):
        """x [B, C, H, W] -> (mu, logvar), each [B, D, H/f, W/f], unclamped."""
        h = self.encoder(x)
        if self.latent_norm is not None:
            h = self.latent_norm(h)
        return self.conv_mu(h), self.conv_logvar(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, D, h, w] -> logits [B, C, h*f, w*f]."""
        return self.decoder(z)

    def forward(self, x: torch.Tensor, sample: bool = False):
        """(reconstruction logits, mu, logvar), decoding the clamped mean.
        Sampling (``sample=True``) belongs to training, not yet ported."""
        if sample:
            raise NotImplementedError("sampling the latent is not yet ported")
        cfg = self.config
        mu, logvar = self.encode(x)
        mu = mu.clamp(-cfg.mu_clip, cfg.mu_clip)
        logvar = logvar.clamp(*cfg.logvar_clip)
        return self.decode(mu), mu, logvar


@torch.no_grad()
def init_weights(model: TransVAE, generator: torch.Generator | None = None) -> TransVAE:
    """The JAX package's initializers: Kaiming fan-out normal convs,
    truncated-normal(0.02) linears, unit norm scales, zero biases, and a
    small-variance init of the latent heads."""
    for m in model.modules():
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


def count_params(model: nn.Module) -> dict:
    """Parameter counts: total, encoder, decoder (works on a meta model)."""
    def _count(m):
        return sum(p.numel() for p in m.parameters())
    return {"total": _count(model), "encoder": _count(model.encoder),
            "decoder": _count(model.decoder)}
