"""TransVAE training losses as plain functions (PyTorch port of
``losses/vae_loss.py``), NCHW.

- The decoder emits unbounded logits; ``sigmoid`` is applied inside the
  loss, in fp32, for every image-space term; targets are in [0, 1].
- L1 on [0, 1] images; LPIPS inputs mapped to [-1, 1] and clamped.
- KL in fp32 with logvar clamped to ``logvar_clip``, mean over all elements.
- A term whose weight is 0 is an fp32 zero; ``total`` is the explicit sum.
- VF alignment to a frozen teacher through an eagerly created projection.
- :func:`make_self_perceptual`: the perceptual term from a trained model's
  own frozen encoder, in the LPIPS slot.
- Under an ambient context group (``parallel.context``: every tensor is
  this rank's rows of each image, the ranks' shares equal or not) the L1
  and KL terms are this rank's row means weighted by its share of the
  global rows (``context.row_mean``; the steps' average over the group is
  the global mean), LPIPS and the self-perceptual distance each image's
  weighted row mean averaged over the group, and the VF and GAN terms read
  each image's gathered rows (``context.whole_rows``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import context as cp
from ..parallel.collectives import global_mean
from .lpips import lpips as lpips_distance


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Defaults per the reference (patched vae_loss.py:31-38)."""

    l1: float = 1.0
    lpips: float = 1.0
    kl: float = 1e-8
    vf: float = 0.1
    gan: float = 0.05
    logvar_clip: tuple = (-30.0, 20.0)


def l1_loss(recon_img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean |recon - target| in fp32 (under context: ``row_mean``)."""
    return cp.row_mean((recon_img.float() - target.float()).abs(), (0, 1, 2, 3))


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor,
                  clip: tuple = (-30.0, 20.0)) -> torch.Tensor:
    """Mean KL(q(z|x) || N(0, 1)) in fp32 (under context: ``row_mean``)."""
    mu32 = mu.float()
    logvar32 = logvar.float().clamp(clip[0], clip[1])
    return cp.row_mean(-0.5 * (1.0 + logvar32 - mu32.square() - logvar32.exp()), (0, 1, 2, 3))


def vf_loss(latent: torch.Tensor, dino_features: torch.Tensor,
            proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
            margin: float = 0.4, data_group=None) -> torch.Tensor:
    """Visual-feature alignment: latent [B, D, h, w] against the teacher's
    map [B, C, hd, wd]; the latent is resized (bilinear) to the teacher's
    grid and projected D -> C by ``proj_kernel`` [D, C] and ``proj_bias``
    when the widths differ; hinge on the mean cosine similarity. With
    ``data_group`` (data parallelism) the mean is over the whole batch,
    every rank's rows, before the hinge (``collectives.global_mean``)."""
    lat = latent.float()
    d, cd = lat.shape[1], dino_features.shape[1]
    if lat.shape[2:] != dino_features.shape[2:]:
        lat = F.interpolate(lat, size=dino_features.shape[2:], mode="bilinear",
                            align_corners=False, antialias=True)
    lat = lat.permute(0, 2, 3, 1)
    if d != cd:
        lat = lat @ proj_kernel.float() + proj_bias.float()
    lat_n = lat / (lat.norm(dim=-1, keepdim=True) + 1e-8)
    din = dino_features.float().permute(0, 2, 3, 1)
    din_n = din / (din.norm(dim=-1, keepdim=True) + 1e-8)
    similarity = (lat_n * din_n).sum(dim=-1).mean()
    if data_group is not None:
        similarity = global_mean(similarity, data_group)
    return torch.clamp(margin - similarity, min=0.0)


def gan_generator_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss: softplus(-D(G(x)))."""
    return F.softplus(-fake_logits.float()).mean()


def discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                       kind: str = "hinge") -> torch.Tensor:
    """D-side GAN loss: bce, hinge or wgan."""
    real, fake = real_logits.float(), fake_logits.float()
    if kind == "bce":
        return F.softplus(-real).mean() + F.softplus(fake).mean()
    if kind == "hinge":
        return F.relu(1.0 - real).mean() + F.relu(1.0 + fake).mean()
    if kind == "wgan":
        return fake.mean() - real.mean()
    raise ValueError(f"Unknown GAN loss kind: {kind!r}")


def make_self_perceptual(model: torch.nn.Module, frozen_state: dict | None = None) -> Callable:
    """Perceptual distance from a trained model's own encoder, frozen: the
    features are the encoder's mu map, unit-normalised over the channels,
    compared by the mean squared distance per image (LPIPS's form with
    uniform weights; the JAX package's substitute where no pretrained VGG
    weights exist -- not LPIPS).

    ``frozen_state`` (a state_dict, e.g. from
    ``training.checkpoint.restore_model_params``) is loaded into ``model``
    (strict) when given, else ``model`` holds the frozen parameters; they
    are set not to require grad. The
    reconstruction's side runs through ``torch.utils.checkpoint``, as JAX
    wraps it in ``jax.checkpoint``: its backward recomputes the encoder
    instead of keeping its activations beside the trained model's. The
    target's side runs under no grad.

    Under an ambient context group the encoder runs context-parallel on the
    rank's rows (``model`` must be built with ``context_axis``; otherwise
    it raises), the recompute under the same group, and each image's
    distance is its weighted row mean (``context.row_mean``) averaged over
    the group (as LPIPS).

    Returns fn(recon [B, 3, H, W] in [0, 1], target) -> [B] distances."""
    if frozen_state is not None:
        model.load_state_dict(frozen_state, strict=True)
    model.requires_grad_(False)

    def feats(x: torch.Tensor) -> torch.Tensor:
        mu, _ = model.encode(x.to(model.config.compute_dtype))
        f = mu.float()
        return f / (f.norm(dim=1, keepdim=True) + 1e-8)

    def fn(recon_img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        state = cp.current()
        if torch.is_grad_enabled() and recon_img.requires_grad:
            # The recompute runs in the backward, which may run outside the
            # caller's block.
            run = feats if state is None else functools.partial(cp.call_in, state, feats)
            fr = checkpoint(run, recon_img, use_reentrant=False)
        else:
            fr = feats(recon_img)
        with torch.no_grad():
            ft = feats(target)
        d = cp.row_mean((fr - ft).square(), (1, 2, 3))
        return d if state is None else global_mean(d, state.group)

    return fn


def transvae_loss(
    recon_logits: torch.Tensor,
    target: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    weights: LossWeights = LossWeights(),
    *,
    lpips_params: dict | None = None,
    perceptual_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    vf_proj: tuple[torch.Tensor, torch.Tensor] | None = None,
    dino_features: torch.Tensor | None = None,
    disc_apply: Callable[[torch.Tensor], torch.Tensor] | None = None,
    data_group=None,
) -> dict[str, torch.Tensor]:
    """Combined weighted loss: a dict of per-term values and 'total', all
    fp32. ``perceptual_fn`` (images in [0, 1] -> [B] distances) replaces the
    VGG-LPIPS term when given. ``data_group``: the VF hinge reads the whole
    batch's similarity (the other terms are means of this rank's rows, which
    the gradient all-reduce averages). Under an ambient context group the
    VF term takes each image's whole ``mu`` and the discriminator each whole
    reconstruction (``dino_features`` must be the whole images' too)."""
    zero = torch.zeros((), device=recon_logits.device)
    losses: dict[str, torch.Tensor] = {}

    recon_img = torch.sigmoid(recon_logits.float())
    target32 = target.float()

    losses["l1"] = (l1_loss(recon_img, target32) * weights.l1
                    if weights.l1 > 0 else zero)

    if weights.lpips > 0 and perceptual_fn is not None:
        losses["lpips"] = perceptual_fn(recon_img, target32).mean() * weights.lpips
    elif weights.lpips > 0 and lpips_params is not None:
        recon_lp = (recon_img * 2.0 - 1.0).clamp(-1.0, 1.0)
        targ_lp = (target32 * 2.0 - 1.0).clamp(-1.0, 1.0)
        losses["lpips"] = lpips_distance(lpips_params, recon_lp, targ_lp).mean() * weights.lpips
    else:
        losses["lpips"] = zero

    losses["kl"] = (kl_divergence(mu, logvar, weights.logvar_clip) * weights.kl
                    if weights.kl > 0 else zero)

    if weights.vf > 0 and dino_features is not None and vf_proj is not None:
        losses["vf"] = vf_loss(cp.whole_rows(mu), dino_features, *vf_proj,
                               data_group=data_group) * weights.vf
    else:
        losses["vf"] = zero

    if weights.gan > 0 and disc_apply is not None:
        losses["gan"] = gan_generator_loss(disc_apply(cp.whole_rows(recon_img))) * weights.gan
    else:
        losses["gan"] = zero

    losses["total"] = (losses["l1"] + losses["lpips"] + losses["kl"]
                       + losses["vf"] + losses["gan"])
    return losses
