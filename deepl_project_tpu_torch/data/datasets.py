"""Dataset sources (PyTorch port of ``data/datasets.py``, its synthetic
sources): plain iterators of HWC float32 [0, 1] numpy images, drawn from the
same numpy generator calls as the JAX package's, so a seed gives the same
bytes in both. Folder, COCO and Hugging Face sources are not ported yet."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_dataset(resolution: int = 256, num_samples: int = 1024,
                      seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic uniform-noise images (tests, benches, smoke training)."""
    rng = np.random.default_rng(seed)
    for _ in range(num_samples):
        yield rng.random((resolution, resolution, 3), np.float32)


def synthetic_shapes_dataset(resolution: int = 256, num_samples: int = 1024,
                             seed: int = 0) -> Iterator[np.ndarray]:
    """Structured synthetic images (gradient background + random rectangles
    and ellipses): compressible, so reconstruction PSNR means something."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, resolution),
                         np.linspace(0, 1, resolution), indexing="ij")
    for _ in range(num_samples):
        c0 = rng.random(3)
        c1 = rng.random(3)
        angle = rng.random() * 2 * np.pi
        t = (np.cos(angle) * xx + np.sin(angle) * yy)
        t = (t - t.min()) / (np.ptp(t) + 1e-9)
        img = c0 + t[..., None] * (c1 - c0)
        for _ in range(rng.integers(2, 6)):
            color = rng.random(3)
            cy, cx = rng.random(2)
            h, w = 0.05 + 0.3 * rng.random(2)
            if rng.random() < 0.5:  # rectangle
                mask = ((np.abs(yy - cy) < h) & (np.abs(xx - cx) < w))
            else:  # ellipse
                mask = (((yy - cy) / h) ** 2 + ((xx - cx) / w) ** 2) < 1.0
            img = np.where(mask[..., None], color, img)
        yield img.astype(np.float32)


def make_dataset(source: str, resolution: int = 256, **kw) -> Iterator[np.ndarray]:
    """'synthetic' or 'shapes' (keyword arguments ``num_samples``, ``seed``);
    other sources raise NotImplementedError."""
    if source in ("synthetic", "shapes"):
        fn = synthetic_dataset if source == "synthetic" else synthetic_shapes_dataset
        return fn(resolution, **kw)
    raise NotImplementedError(
        f"data source {source!r} is not yet ported to deepl_project_tpu_torch "
        "(synthetic and shapes are)")
