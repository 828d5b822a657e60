"""Building-block ops of the port (NCHW modules, plain tensor functions)."""

from .attention import AttentionRoPE, xla_attention
from .blocks import ResBlock, TransVAEBlock
from .ffn import ConvFFN, StandardFFN
from .norms import GroupNorm, LayerNorm, RMSNorm, gn_groups
from .resample import Downsample, Upsample
from .rope import apply_rope2d, rope2d_tables

__all__ = [
    "AttentionRoPE", "xla_attention", "ResBlock", "TransVAEBlock",
    "ConvFFN", "StandardFFN", "GroupNorm", "LayerNorm", "RMSNorm", "gn_groups",
    "Downsample", "Upsample", "apply_rope2d", "rope2d_tables",
]
