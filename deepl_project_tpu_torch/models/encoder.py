"""TransVAE encoder (PyTorch port of ``models/encoder.py``): a 3x3 conv stem,
``num_cnn_stages`` stages of ResBlocks, then TransVAE blocks, with a
Downsample between every pair of stages.

``remat``: each block runs through ``torch.utils.checkpoint`` under the
config's ``remat_policy`` in a forward that builds a graph; with
``remat_resample`` the Downsamples too, saving nothing (the JAX
``nn.remat(Downsample)`` has no policy).

``scan_blocks``: each stage is one ``ops.stack.BlockStack`` of its
``depths[i]`` blocks (stacked parameters under ``stages.{i}.scan.block``),
the JAX package's ``stage{i}_blocks``; ``stage`` builds either layout."""

from __future__ import annotations

import torch
from torch import nn

from ..config import TransVAEConfig
from ..ops.blocks import ResBlock, TransVAEBlock, resolve_remat_policy, run_block
from ..ops.layers import Conv2d
from ..ops.resample import Downsample
from ..ops.stack import BlockStack


def transformer_kwargs(cfg: TransVAEConfig, dim: int) -> dict:
    return dict(dim=dim, mlp_ratio=cfg.mlp_ratio, head_dim=cfg.head_dim,
                use_rope=cfg.use_rope, rope_pairing=cfg.rope_pairing,
                use_conv_ffn=cfg.use_conv_ffn, conv_ffn_type=cfg.conv_ffn_type,
                attention_impl=cfg.attention_impl, dropout=cfg.dropout,
                calibrate=cfg.quant_calibrate,
                quant=cfg.quant if cfg.quant_scope in ("all", "ffn") else None)


def resblock_kwargs(cfg: TransVAEConfig) -> dict:
    """The int8 settings of the ResBlocks (``quant_scope`` 'all' or
    'resblock'; the ConvFFNs: 'all' or 'ffn', as in the JAX package)."""
    return dict(calibrate=cfg.quant_calibrate,
                quant=cfg.quant if cfg.quant_scope in ("all", "resblock") else None)


def stage(cfg: TransVAEConfig, cnn: bool, dim: int, depth: int, policy, kw: dict
          ) -> nn.Module:
    """A stage of ``depth`` ResBlocks (``cnn``) or TransVAE blocks of width
    ``dim``: a ModuleList, or under ``scan_blocks`` a BlockStack."""
    cls, kwargs = ((ResBlock, dict(in_channels=dim, out_channels=dim, **resblock_kwargs(cfg)))
                   if cnn else (TransVAEBlock, transformer_kwargs(cfg, dim)))
    if cfg.scan_blocks:
        return BlockStack(cls, {**kwargs, **kw}, depth, remat=cfg.remat, policy=policy,
                          device=kw["device"])
    return nn.ModuleList([cls(**kwargs, **kw) for _ in range(depth)])


def run_stage(blocks: nn.Module, h: torch.Tensor, deterministic: bool, cfg: TransVAEConfig,
              policy) -> torch.Tensor:
    """A stage's blocks on ``h`` in order (each checkpointed under ``remat``);
    the ResBlocks take no ``deterministic``, as JAX's ``pass_deterministic``."""
    if isinstance(blocks, BlockStack):
        return blocks(h, *(() if isinstance(blocks.template, ResBlock) else (deterministic,)))
    for block in blocks:
        args = () if isinstance(block, ResBlock) else (deterministic,)
        h = run_block(block, h, *args, remat=cfg.remat, policy=policy)
    return h


class TransVAEEncoder(nn.Module):
    def __init__(self, cfg: TransVAEConfig, *, device=None):
        super().__init__()
        self.config = cfg
        self.remat_policy = resolve_remat_policy(cfg.remat_policy) if cfg.remat else None
        kw = dict(device=device, param_dtype=cfg.params_dtype)
        dims = cfg.base_dims
        self.conv_in = Conv2d(cfg.input_channels, dims[0], 3, padding=1,
                              device=device, dtype=cfg.params_dtype)
        self.stages = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for i in range(cfg.num_stages):
            self.stages.append(stage(cfg, i < cfg.num_cnn_stages, dims[i], cfg.depths[i],
                                     self.remat_policy, kw))
            if i < cfg.num_stages - 1:
                self.downsamples.append(Downsample(dims[i], dims[i + 1],
                                                   cfg.use_dc_path, **kw))

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """x [B, C, H, W] -> features [B, base_dims[-1], H/f, W/f]."""
        cfg = self.config
        x = x.to(cfg.compute_dtype).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(x)
        for i, blocks in enumerate(self.stages):
            h = run_stage(blocks, h, deterministic, cfg, self.remat_policy)
            if i < len(self.downsamples):
                h = run_block(self.downsamples[i], h, remat=cfg.remat and cfg.remat_resample)
        return h
