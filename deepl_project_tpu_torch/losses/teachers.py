"""Frozen teacher networks for the VF alignment loss (PyTorch port of
``losses/teachers.py``).

A teacher is a callable ``images [B, 3, H, W] in [0, 1] -> features
[B, C, h, w]`` (the port's NCHW; the JAX teachers take and give NHWC) with a
``feature_dim`` attribute, from which the trainer sizes the eager VF
projection. It runs under no grad: the teacher is frozen.

- :func:`make_dino_teacher`: DINOv2 through ``transformers`` with
  ``local_files_only=True``, or None where its weights are not on this
  machine (nothing is downloaded).
- :func:`make_stub_teacher`: a fixed random patch projection with DINOv2's
  shapes, weight-free, so the VF path runs where DINOv2 is absent.
- :func:`make_vf_teacher`: the training CLI's choice, DINOv2 or else the
  stub with the JAX package's warning.

Known deviation, tested: the JAX stub draws its projection with
``jax.random``, which a package without JAX cannot reproduce; the port's
stub draws it from a seeded ``torch.Generator`` (its own init, as for the
model) and takes ``proj`` (numpy) to carry the JAX stub's projection across.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """images [B, C, H, W] -> fp32 [B, C, size, size]: bilinear with the
    antialiasing ``jax.image.resize(method='bilinear')`` applies when it
    shrinks an image."""
    return F.interpolate(images.float(), size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def make_resize_teacher(backbone: Callable, size: int = 224) -> Callable:
    """Wrap a feature function with the reference's bilinear resize to
    ``size``, under no grad."""

    @torch.no_grad()
    def teacher(images: torch.Tensor) -> torch.Tensor:
        return backbone(resize_bilinear(images, size))

    return teacher


def dinov2_available(model_name: str = "facebook/dinov2-base") -> bool:
    """Whether ``transformers`` finds the model's files on this machine."""
    try:
        from transformers import AutoConfig

        AutoConfig.from_pretrained(model_name, local_files_only=True)
        return True
    except Exception:  # no transformers, no local files, or a broken cache
        return False


class DinoV2Teacher:
    """Frozen DINOv2 feature map: the patch tokens (CLS dropped) on their
    grid, [B, hidden, H/p, W/p]."""

    def __init__(self, model_name: str = "facebook/dinov2-base", device=None):
        from transformers import AutoModel

        self.model = AutoModel.from_pretrained(model_name, local_files_only=True)
        self.model.eval().requires_grad_(False)
        if device is not None:
            self.model.to(device)
        self.feature_dim = self.model.config.hidden_size
        self.patch = self.model.config.patch_size

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        b, _, h, w = images.shape
        mean = images.new_tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
        std = images.new_tensor(_IMAGENET_STD).view(1, 3, 1, 1)
        out = self.model(pixel_values=(images.float() - mean) / std)
        tokens = out.last_hidden_state[:, 1:, :]
        gh, gw = h // self.patch, w // self.patch
        return tokens.reshape(b, gh, gw, self.feature_dim).permute(0, 3, 1, 2)


def make_dino_teacher(model_name: str = "facebook/dinov2-base", resize: int = 224,
                      device=None) -> Callable | None:
    """The reference's VF teacher (resize, then DINOv2), or None when the
    pretrained weights are not on this machine."""
    if not dinov2_available(model_name):
        return None
    teacher = DinoV2Teacher(model_name, device=device)
    fn = make_resize_teacher(teacher, resize)
    fn.feature_dim = teacher.feature_dim
    return fn


def make_stub_teacher(feature_dim: int = 768, patch: int = 14, resize: int = 224,
                      seed: int = 0, proj: np.ndarray | None = None,
                      device=None) -> Callable:
    """A weight-free VF teacher: a fixed random projection of each
    ``patch`` x ``patch`` x 3 patch of the resized image to ``feature_dim``
    channels, N(0, 1) scaled by 1/sqrt(patch^2 * 3) -- DINOv2's shapes
    ([B, feature_dim, 224/p, 224/p]) without its semantics. The projection
    [patch^2 * 3, feature_dim] (rows in (row, column, channel) order within
    a patch) is ``proj`` when given, else drawn from a ``torch.Generator``
    seeded with ``seed``."""
    fan = patch * patch * 3
    if proj is None:
        gen = torch.Generator().manual_seed(seed)
        w = torch.randn(fan, feature_dim, generator=gen) / math.sqrt(fan)
    else:
        w = torch.from_numpy(np.array(proj, np.float32))
        if tuple(w.shape) != (fan, feature_dim):
            raise ValueError(f"proj must be [{fan}, {feature_dim}], got {tuple(w.shape)}")
    w = w.to(device)

    def backbone(x: torch.Tensor) -> torch.Tensor:
        b, c, h, wd = x.shape
        gh, gw = h // patch, wd // patch
        x = x[:, :, :gh * patch, :gw * patch].permute(0, 2, 3, 1)
        patches = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
        feats = patches.reshape(b, gh, gw, patch * patch * c) @ w.to(x.device)
        return feats.permute(0, 3, 1, 2)

    fn = make_resize_teacher(backbone, resize)
    fn.feature_dim = feature_dim
    return fn


def make_vf_teacher(model_name: str = "facebook/dinov2-base", allow_stub: bool = True,
                    device=None) -> Callable | None:
    """The training CLI's teacher: DINOv2 where its weights are on this
    machine, else the stub (with the JAX package's warning), so that
    ``--vf_weight > 0`` always builds a working VF path."""
    fn = make_dino_teacher(model_name, device=device)
    if fn is not None:
        return fn
    if not allow_stub:
        return None
    print("[teachers] WARNING: DINOv2 weights not locally available; using "
          "the deterministic stub teacher (VF path exercised, semantics "
          "need real weights)")
    return make_stub_teacher(device=device)
