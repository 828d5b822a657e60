"""TransVAE decoder (PyTorch port of ``models/decoder.py``), symmetric to the
encoder: a 3x3 conv from the latent, transformer stages, then CNN stages,
with an Upsample between stages, and a final GroupNorm -> SiLU -> 3x3 conv.

Output contract: unbounded logits; apply a sigmoid for [0, 1] images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransVAEConfig
from ..ops.blocks import ResBlock, TransVAEBlock
from ..ops.layers import Conv2d
from ..ops.norms import GroupNorm, gn_groups
from ..ops.resample import Upsample
from .encoder import transformer_kwargs


class TransVAEDecoder(nn.Module):
    def __init__(self, cfg: TransVAEConfig, *, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(device=device, param_dtype=cfg.params_dtype)
        pkw = dict(device=device, dtype=cfg.params_dtype)
        depths = tuple(reversed(cfg.depths))
        dims = tuple(reversed(cfg.base_dims))
        n_transformer = cfg.num_stages - cfg.num_cnn_stages
        self.conv_in = Conv2d(cfg.latent_dim, dims[0], 3, padding=1, **pkw)
        self.stages = nn.ModuleList()
        self.upsamples = nn.ModuleList()
        for i in range(cfg.num_stages):
            if i >= n_transformer:
                blocks = [ResBlock(dims[i], dims[i], **kw) for _ in range(depths[i])]
            else:
                blocks = [TransVAEBlock(**transformer_kwargs(cfg, dims[i]), **kw)
                          for _ in range(depths[i])]
            self.stages.append(nn.ModuleList(blocks))
            if i < cfg.num_stages - 1:
                self.upsamples.append(Upsample(dims[i], dims[i + 1],
                                               cfg.use_dc_path, **kw))
        self.norm_out = GroupNorm(gn_groups(dims[-1]), dims[-1], **pkw)
        self.conv_out = Conv2d(dims[-1], cfg.input_channels, 3, padding=1, **pkw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, D, h, w] -> logits [B, C, h*f, w*f]."""
        z = z.to(self.config.compute_dtype).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(z)
        for i, stage in enumerate(self.stages):
            for block in stage:
                h = block(h)
            if i < len(self.upsamples):
                h = self.upsamples[i](h)
        return self.conv_out(F.silu(self.norm_out(h)))
