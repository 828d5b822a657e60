"""TransVAE decoder (PyTorch port of ``models/decoder.py``), symmetric to the
encoder: a 3x3 conv from the latent, transformer stages, then CNN stages,
with an Upsample between stages, and a final GroupNorm -> SiLU -> 3x3 conv.

Output contract: unbounded logits; apply a sigmoid for [0, 1] images.
Gradient checkpointing as in the encoder (``remat``, ``remat_resample``:
the Upsamples), and so is ``scan_blocks`` (stage i stacks ``depths``
reversed, as the JAX decoder). The final GroupNorm -> SiLU goes through
``norms.group_norm_silu``, as the ResBlocks' do.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import TransVAEConfig
from ..ops.blocks import resolve_remat_policy, run_block
from ..ops.layers import Conv2d
from ..ops.norms import GroupNorm, gn_groups, group_norm_silu
from ..ops.resample import Upsample
from .encoder import run_stage, stage


class TransVAEDecoder(nn.Module):
    def __init__(self, cfg: TransVAEConfig, *, device=None):
        super().__init__()
        self.config = cfg
        self.remat_policy = resolve_remat_policy(cfg.remat_policy) if cfg.remat else None
        kw = dict(device=device, param_dtype=cfg.params_dtype)
        pkw = dict(device=device, dtype=cfg.params_dtype)
        depths = tuple(reversed(cfg.depths))
        dims = tuple(reversed(cfg.base_dims))
        n_transformer = cfg.num_stages - cfg.num_cnn_stages
        self.conv_in = Conv2d(cfg.latent_dim, dims[0], 3, padding=1, **pkw)
        self.stages = nn.ModuleList()
        self.upsamples = nn.ModuleList()
        for i in range(cfg.num_stages):
            self.stages.append(stage(cfg, i >= n_transformer, dims[i], depths[i],
                                     self.remat_policy, kw))
            if i < cfg.num_stages - 1:
                self.upsamples.append(Upsample(dims[i], dims[i + 1],
                                               cfg.use_dc_path, **kw))
        self.norm_out = GroupNorm(gn_groups(dims[-1]), dims[-1], **pkw)
        self.conv_out = Conv2d(dims[-1], cfg.input_channels, 3, padding=1, **pkw)

    def forward(self, z: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """z [B, D, h, w] -> logits [B, C, h*f, w*f]."""
        cfg = self.config
        z = z.to(cfg.compute_dtype).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(z)
        for i, blocks in enumerate(self.stages):
            h = run_stage(blocks, h, deterministic, cfg, self.remat_policy)
            if i < len(self.upsamples):
                h = run_block(self.upsamples[i], h, remat=cfg.remat and cfg.remat_resample)
        return self.conv_out(group_norm_silu(self.norm_out, h))
