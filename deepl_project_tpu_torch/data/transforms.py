"""Host-side image transforms (PyTorch port of ``data/transforms.py``).

The reference pipeline Resize(res) -> CenterCrop(res) -> ToTensor() -> [0, 1],
on PIL images, giving HWC float32 numpy arrays (the layout of the port's
data sources; the model's callers move them to NCHW). PIL is imported when a
function needs it, so the package imports without it; those functions raise
a clear error where it is absent.
"""

from __future__ import annotations

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading image files needs PIL (the Pillow package), "
                          "which is not installed") from e
    return Image


def pil_available() -> bool:
    try:
        _pil()
    except ImportError:
        return False
    return True


def resize_shorter_side(img, size: int):
    """torchvision.Resize(int) semantics: shorter side -> size, keep aspect."""
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), _pil().BILINEAR)


def center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def to_array(img) -> np.ndarray:
    """RGB uint8 -> float32 [0,1], HWC."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0


def preprocess_image(img, resolution: int = 256) -> np.ndarray:
    """Full reference transform: resize -> center crop -> [0,1] float HWC."""
    img = resize_shorter_side(img, resolution)
    img = center_crop(img, resolution)
    return to_array(img)


def preprocess_file(path: str, resolution: int = 256) -> np.ndarray:
    with _pil().open(path) as img:
        return preprocess_image(img, resolution)
