"""rFID (reconstruction FID) machinery (PyTorch port of ``utils/fid.py``).

Feature statistics and the Fréchet distance in numpy/scipy, with a pluggable
feature extractor. The InceptionV3 extractor of the paper's protocol
(``utils/inception.py``) needs converted weights that are not in the
repository (``WEIGHTS.md``); without them evaluation uses pooled VGG
features (``evaluation.make_vgg_feature_fn``, reported under ``vgg_rfid``). ``fid_from_features`` also serves any other
feature sets, e.g. latents.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import scipy.linalg


def feature_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of [N, D] features, in float64."""
    f = np.asarray(features, np.float64)
    return f.mean(axis=0), np.cov(f, rowvar=False)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FID = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))."""
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    return frechet_distance(*feature_statistics(real), *feature_statistics(fake))


def rfid(real_batches: Iterator, recon_batches: Iterator,
         feature_fn: Callable) -> float:
    """Reconstruction FID over paired batch streams using ``feature_fn``
    (any perceptual embedding returning [B, D] features)."""
    real_feats, fake_feats = [], []
    for r, f in zip(real_batches, recon_batches):
        real_feats.append(_numpy(feature_fn(r)))
        fake_feats.append(_numpy(feature_fn(f)))
    return fid_from_features(np.concatenate(real_feats), np.concatenate(fake_feats))


def _numpy(x) -> np.ndarray:
    """Features as a numpy array (tensors are copied from their device)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
