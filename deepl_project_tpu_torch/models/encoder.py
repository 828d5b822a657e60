"""TransVAE encoder (PyTorch port of ``models/encoder.py``): a 3x3 conv stem,
``num_cnn_stages`` stages of ResBlocks, then TransVAE blocks, with a
Downsample between every pair of stages."""

from __future__ import annotations

import torch
from torch import nn

from ..config import TransVAEConfig
from ..ops.blocks import ResBlock, TransVAEBlock
from ..ops.layers import Conv2d
from ..ops.resample import Downsample


def transformer_kwargs(cfg: TransVAEConfig, dim: int) -> dict:
    return dict(dim=dim, mlp_ratio=cfg.mlp_ratio, head_dim=cfg.head_dim,
                use_rope=cfg.use_rope, rope_pairing=cfg.rope_pairing,
                use_conv_ffn=cfg.use_conv_ffn, conv_ffn_type=cfg.conv_ffn_type,
                attention_impl=cfg.attention_impl, calibrate=cfg.quant_calibrate,
                quant=cfg.quant if cfg.quant_scope in ("all", "ffn") else None)


def resblock_kwargs(cfg: TransVAEConfig) -> dict:
    """The int8 settings of the ResBlocks (``quant_scope`` 'all' or
    'resblock'; the ConvFFNs: 'all' or 'ffn', as in the JAX package)."""
    return dict(calibrate=cfg.quant_calibrate,
                quant=cfg.quant if cfg.quant_scope in ("all", "resblock") else None)


class TransVAEEncoder(nn.Module):
    def __init__(self, cfg: TransVAEConfig, *, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(device=device, param_dtype=cfg.params_dtype)
        dims = cfg.base_dims
        self.conv_in = Conv2d(cfg.input_channels, dims[0], 3, padding=1,
                              device=device, dtype=cfg.params_dtype)
        self.stages = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for i in range(cfg.num_stages):
            if i < cfg.num_cnn_stages:
                blocks = [ResBlock(dims[i], dims[i], **resblock_kwargs(cfg), **kw)
                          for _ in range(cfg.depths[i])]
            else:
                blocks = [TransVAEBlock(**transformer_kwargs(cfg, dims[i]), **kw)
                          for _ in range(cfg.depths[i])]
            self.stages.append(nn.ModuleList(blocks))
            if i < cfg.num_stages - 1:
                self.downsamples.append(Downsample(dims[i], dims[i + 1],
                                                   cfg.use_dc_path, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> features [B, base_dims[-1], H/f, W/f]."""
        x = x.to(self.config.compute_dtype).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(x)
        for i, stage in enumerate(self.stages):
            for block in stage:
                h = block(h)
            if i < len(self.downsamples):
                h = self.downsamples[i](h)
        return h
