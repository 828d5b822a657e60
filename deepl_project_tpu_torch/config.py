"""Model configuration and the variant registry (PyTorch port).

Same fields, defaults and variants as ``deepl_project_tpu/config.py``; the
only difference is that ``compute_dtype``/``params_dtype`` resolve to torch
dtypes. Fields of parts of the JAX package the port's model does not take
(``scan_blocks``, ``context_axis``) are kept so configs round-trip between
the packages; the model refuses those settings instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class TransVAEConfig:
    """Static architecture configuration for one TransVAE variant.

    Spatial compression is ``2 ** (len(depths) - 1)``: a 5-stage model is f16,
    a 4-stage model is f8.
    """

    variant: str = "large"
    depths: Sequence[int] = (3, 3, 3, 4, 6)
    base_dims: Sequence[int] = (192, 192, 384, 768, 1536)
    latent_dim: int = 32
    input_channels: int = 3
    mlp_ratio: float = 1.0
    head_dim: int = 64
    num_cnn_stages: int = 2  # first N encoder stages are CNN
    use_rope: bool = True
    # 'reference' replicates the reference's nonstandard rotary pairing
    # (needed for converted-checkpoint parity); 'standard' is a true rotation.
    rope_pairing: str = "reference"
    use_conv_ffn: bool = True
    conv_ffn_type: str = "full"  # 'full' | 'depthwise'
    use_dc_path: bool = True
    dropout: float = 0.0
    mu_clip: float = 50.0
    logvar_clip: tuple = (-30.0, 20.0)
    # GroupNorm on the encoder output before the mu/logvar heads (False =
    # exact reference structure, required for converted checkpoints).
    norm_latents: bool = False
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    remat: bool = False  # per-block gradient checkpointing
    remat_resample: bool = False  # also checkpoint Down/Upsample
    # 'none' | 'dots' | 'dots_all' | 'conv_dots': the outputs a checkpointed
    # block keeps (ops/blocks.py resolve_remat_policy).
    remat_policy: str = "dots"
    scan_blocks: bool = False
    attention_impl: str = "auto"
    context_axis: str | None = None
    quant: str | None = None
    quant_scope: str = "all"
    quant_calibrate: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def compression_ratio(self) -> int:
        return 2 ** (self.num_stages - 1)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "TransVAEConfig":
        return dataclasses.replace(self, **kw)


# (depths, base_dims) per stage; mlp_ratio=1.0, head_dim=64 throughout.
VARIANTS: dict[str, dict] = {
    "tiny_f16d32": dict(
        depths=(3, 3, 3, 3, 3), base_dims=(128, 128, 256, 256, 512), latent_dim=32
    ),
    "base_f16d32": dict(
        depths=(3, 3, 3, 3, 3), base_dims=(128, 128, 256, 512, 1024), latent_dim=32
    ),
    "large_f16d32": dict(
        depths=(3, 3, 3, 4, 6), base_dims=(192, 192, 384, 768, 1536), latent_dim=32
    ),
    "huge_f16d32": dict(
        depths=(3, 3, 4, 6, 8), base_dims=(256, 256, 512, 1024, 2048), latent_dim=32
    ),
    "giant_f16d32": dict(
        depths=(3, 3, 4, 8, 10), base_dims=(320, 320, 640, 1280, 2560), latent_dim=32
    ),
    "large_f8d16": dict(
        depths=(3, 3, 6, 8), base_dims=(192, 384, 768, 1536), latent_dim=16
    ),
    "tiny_f8d16": dict(
        depths=(3, 3, 3, 3), base_dims=(128, 128, 256, 512), latent_dim=16
    ),
}


def get_config(
    variant: str = "large", compression_ratio: int = 16, latent_dim: int | None = None, **kw
) -> TransVAEConfig:
    """Resolve a variant name + f/d into a full config.

    Accepts either a bare variant ('large') with compression_ratio/latent_dim, or a
    full registry key ('large_f16d32').
    """
    if variant in VARIANTS:
        key = variant
    else:
        d = latent_dim if latent_dim is not None else (32 if compression_ratio == 16 else 16)
        key = f"{variant}_f{compression_ratio}d{d}"
    if key not in VARIANTS:
        raise ValueError(
            f"Unknown variant {variant!r} (f{compression_ratio}); known: {sorted(VARIANTS)}"
        )
    spec = dict(VARIANTS[key])
    if latent_dim is not None:
        spec["latent_dim"] = latent_dim
    spec.update(kw)
    return TransVAEConfig(variant=key, **spec)
