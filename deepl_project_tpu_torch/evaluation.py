"""Evaluation harness (PyTorch port of ``evaluation.py``): PSNR/SSIM/LPIPS
over a dataset, reconstruction grids, random sampling, interpolation and
resolution-extrapolation sweeps.

Reference counterparts: evaluate.py:68-193 (metrics loop) and the patched
evaluate_transvae.py:109-341 (on-device metrics, sigmoid on logits,
metrics.json, comparison grids, random samples),
scripts/reproduce/test_rope_extrapolation.py (PSNR at 256/512/1024).

Images cross the public functions as the JAX package's do: NHWC arrays in
[0, 1] (numpy, or tensors). Inside, the model runs on NCHW tensors on its own
device, and everything -- forward, sigmoid, PSNR/SSIM/LPIPS, features -- stays
there until the per-image vectors. ``params`` is the weights to evaluate:
None for the model's own, a state_dict, or a checkpoint state as
``training/checkpoint.py`` saves it ({'model': state_dict, ...}), which is
loaded into ``model`` first.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from .losses import get_lpips_params, lpips as lpips_distance, lpips_params_available
from .models.transvae import TransVAE
from .utils.image import make_grid, save_image
from .utils.metrics import psnr, ssim, summarize


def _device(model: TransVAE) -> torch.device:
    return next(model.parameters()).device


def load_params(model: TransVAE, params: Any) -> TransVAE:
    """``model`` holding ``params`` (None: as it is; a checkpoint state's
    'model' entry or a state_dict: loaded with strict=True)."""
    if params is None:
        return model
    state = params["model"] if isinstance(params, dict) and "model" in params else params
    model.load_state_dict(state, strict=True)
    return model


def _nchw(images, device) -> torch.Tensor:
    """NHWC [0, 1] images -> an fp32 NCHW tensor on ``device``."""
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
    return x.to(device, torch.float32).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().cpu().numpy()


def default_lpips_params(device) -> dict:
    """LPIPS/VGG weights on ``device``: the converted pretrained file when it
    exists, else random-init VGG drawn from seed 0, with a warning."""
    params = get_lpips_params(device=device,
                              generator=torch.Generator(device=device).manual_seed(0))
    if not lpips_params_available():
        print("[evaluation] WARNING: no pretrained LPIPS weights found; using "
              "random-init VGG (LPIPS and vgg_rfid are then not perceptual metrics)")
    return params


def make_metric_step(model: TransVAE, lpips_params: dict | None = None):
    """step(x) for an NCHW [0, 1] batch on the model's device -> (recon in
    [0, 1] fp32 NCHW, {'psnr', 'ssim'[, 'lpips']: per-image [B] tensors})."""

    @torch.inference_mode()
    def step(x: torch.Tensor):
        logits, _, _ = model(x.to(model.config.compute_dtype), sample=False)
        recon = torch.sigmoid(logits.float())
        target = x.float()
        out = {"psnr": psnr(recon, target), "ssim": ssim(recon, target)}
        if lpips_params is not None:
            out["lpips"] = lpips_distance(lpips_params, recon * 2.0 - 1.0,
                                          target * 2.0 - 1.0)
        return recon, out

    return step


def make_vgg_feature_fn(lpips_params: dict):
    """Perceptual features for FID-style metrics: the deepest VGG tap,
    spatially pooled, [B, 512] for NCHW [0, 1] images. A VGG-feature FID, not
    InceptionV3 rFID: relative comparisons hold, absolute values are not
    comparable with the paper's Table 1."""
    from .losses.lpips import _vgg_features

    @torch.inference_mode()
    def feature_fn(images01: torch.Tensor) -> torch.Tensor:
        taps = _vgg_features(lpips_params, images01.float() * 2.0 - 1.0)
        return taps[-1].mean(dim=(2, 3))

    return feature_fn


def make_fid_feature_fn(device=None, lpips_params: dict | None = None) -> tuple:
    """(feature_fn, metric_key) for NCHW [0, 1] images on ``device``:
    InceptionV3 pool3 features under 'rfid' where the converted weights
    exist (``utils/inception.py``'s ``DEFAULT_WEIGHTS_PATH``), else pooled
    VGG features under 'vgg_rfid', so relative-only numbers are never taken
    for paper-comparable ones."""
    from .utils.inception import inception_params_available, make_inception_feature_fn

    if inception_params_available():
        return make_inception_feature_fn(device=device), "rfid"
    if lpips_params is None:
        lpips_params = default_lpips_params(device)
    return make_vgg_feature_fn(lpips_params), "vgg_rfid"


def evaluate_model(model: TransVAE, params: Any, batches: Iterator,
                   use_lpips: bool = True, max_batches: int | None = None,
                   output_dir: str | None = None, save_grids: int = 0,
                   compute_rfid: bool = False,
                   lpips_params: dict | None = None) -> dict:
    """Reconstruction metrics over NHWC [0, 1] batches; returns {metric:
    summary, 'num_images': n[, '(vgg_)rfid': value]} and optionally writes
    metrics.json and comparison grids (inputs above, reconstructions below).
    ``lpips_params`` defaults to :func:`default_lpips_params`."""
    model = load_params(model, params).eval()
    device = _device(model)
    if lpips_params is None and (use_lpips or compute_rfid):
        lpips_params = default_lpips_params(device)
    step = make_metric_step(model, lpips_params if use_lpips else None)
    feature_fn = rfid_key = None
    if compute_rfid:
        feature_fn, rfid_key = make_fid_feature_fn(device, lpips_params)
    real_feats: list = []
    fake_feats: list = []
    collected: dict[str, list] = {}
    grids_saved = n_images = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        x = _nchw(batch, device)
        recon, metrics = step(x)
        for name, vals in metrics.items():
            collected.setdefault(name, []).append(vals.float().cpu().numpy())
        if feature_fn is not None:
            real_feats.append(feature_fn(x).cpu().numpy())
            fake_feats.append(feature_fn(recon).cpu().numpy())
        n_images += x.shape[0]
        if output_dir and grids_saved < save_grids:
            pair = np.concatenate([_nhwc(x), _nhwc(recon)], axis=0)
            os.makedirs(output_dir, exist_ok=True)
            save_image(make_grid(pair, nrow=x.shape[0]),
                       os.path.join(output_dir, f"comparison_{i:03d}.png"))
            grids_saved += 1

    results: dict = {name: summarize(np.concatenate(vals))
                     for name, vals in collected.items()}
    results["num_images"] = n_images
    if feature_fn is not None and n_images > 1:
        from .utils.fid import fid_from_features

        results[rfid_key] = fid_from_features(np.concatenate(real_feats),
                                              np.concatenate(fake_feats))
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "metrics.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


def resize_images(x: torch.Tensor, res: int) -> torch.Tensor:
    """NCHW fp32 images -> res x res with ``jax.image.resize(method='linear')``'s
    semantics: a triangle kernel widened by the downscale factor (antialias)."""
    return F.interpolate(x, size=(res, res), mode="bilinear", antialias=True,
                         align_corners=False)


def extrapolation_sweep(model: TransVAE, params: Any, images,
                        resolutions: tuple = (256, 512, 1024),
                        compute_rfid: bool = False, chunk: int | None = None,
                        lpips_params: dict | None = None) -> dict:
    """PSNR (+ SSIM, + optional (vgg_)rfid) at several inference resolutions
    from one model -- the RoPE extrapolation experiment (ref:
    test_rope_extrapolation.py:28-140; the paper's Table 1 reports rFID and
    PSNR per resolution).

    ``images`` [B, H, W, 3] in [0, 1] must be at the largest resolution; the
    others are made by :func:`resize_images`. ``chunk`` bounds the images per
    forward (1024px stage 2 is N=65536 tokens). Each resolution's entry keeps
    the PSNR summary at its top level, with ``ssim`` and the rfid nested."""
    model = load_params(model, params).eval()
    device = _device(model)
    feature_fn = rfid_key = None
    if compute_rfid:
        feature_fn, rfid_key = make_fid_feature_fn(device, lpips_params)
    full = _nchw(images, device)
    b, _, h, _ = full.shape
    step_size = min(chunk or b, b)
    results = {}
    for res in resolutions:
        batch = full if h == res else resize_images(full, res)
        psnrs, ssims, real_f, fake_f = [], [], [], []
        with torch.inference_mode():
            for i in range(0, b, step_size):
                xb = batch[i:i + step_size]
                logits, _, _ = model(xb.to(model.config.compute_dtype), sample=False)
                recon = torch.sigmoid(logits.float())
                psnrs.append(psnr(recon, xb).cpu().numpy())
                ssims.append(ssim(recon, xb).cpu().numpy())
                if feature_fn is not None:
                    real_f.append(feature_fn(xb).cpu().numpy())
                    fake_f.append(feature_fn(recon).cpu().numpy())
                del logits, recon
        entry = summarize(np.concatenate(psnrs))
        entry["ssim"] = summarize(np.concatenate(ssims))
        if feature_fn is not None and b > 1:
            from .utils.fid import fid_from_features

            entry[rfid_key] = fid_from_features(np.concatenate(real_f),
                                                np.concatenate(fake_f))
        results[res] = entry
        del batch
    return results


@torch.inference_mode()
def generate_random(model: TransVAE, params: Any,
                    generator: torch.Generator | None = None,
                    num_samples: int = 16, latent_hw: int = 16) -> np.ndarray:
    """Decode z ~ N(0, 1) latents [N, D, h, w] drawn from ``generator`` on the
    model's device (ref: generate_images.py:76-108); NHWC [0, 1] images."""
    model = load_params(model, params).eval()
    device = _device(model)
    z = torch.randn(num_samples, model.config.latent_dim, latent_hw, latent_hw,
                    generator=generator, device=device)
    return _nhwc(torch.sigmoid(model.decode(z).float()))


@torch.inference_mode()
def generate_interpolation(model: TransVAE, params: Any, image_a: np.ndarray,
                           image_b: np.ndarray, steps: int = 8) -> np.ndarray:
    """Linear interpolation between two HWC images' latent means
    (ref: generate_images.py:112-143); NHWC [0, 1] images."""
    model = load_params(model, params).eval()
    x = _nchw(np.stack([np.asarray(image_a), np.asarray(image_b)]), _device(model))
    mu, _ = model.encode(x)
    mu = mu.float()
    alphas = torch.linspace(0.0, 1.0, steps, device=mu.device).reshape(steps, 1, 1, 1)
    z = (1 - alphas) * mu[0] + alphas * mu[1]
    return _nhwc(torch.sigmoid(model.decode(z).float()))


@torch.inference_mode()
def reconstruct(model: TransVAE, params: Any, images) -> np.ndarray:
    """Deterministic encode -> mean -> decode of NHWC [0, 1] images (ref:
    inference_example.py:34-80 uses mu); NHWC [0, 1] images."""
    model = load_params(model, params).eval()
    logits, _, _ = model(_nchw(images, _device(model)), sample=False)
    return _nhwc(torch.sigmoid(logits.float()))


def model_from_checkpoint(directory: str, device=None, step: int | None = None) -> TransVAE:
    """The model of a checkpoint directory (``config.json`` and the newest, or
    the given, ``ckpt_<step>.pt``) on ``device`` (default CUDA)."""
    from .models.transvae import resolve_device
    from .training.checkpoint import load_config, restore_checkpoint

    device = resolve_device(device)
    with torch.device("meta"):
        model = TransVAE(load_config(directory))
    model = model.to_empty(device=device)
    state, _ = restore_checkpoint(directory, step, map_location=device)
    return load_params(model, state).eval()
