"""Image and layout helpers (PyTorch port of ``utils/image.py``): NCHW <->
NHWC for numpy arrays, [0, 1] -> uint8, grid assembly, and PNG writing.

``save_image`` writes the PNG with the standard library alone (``zlib`` and
``struct``): 8-bit grey, RGB or RGBA, one unfiltered scanline per row. The
port's machines need no image library to save evaluation grids.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# PNG colour types by channel count: grey, RGB, RGBA.
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def nchw_to_nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def nhwc_to_nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8, rounding half up (x * 255 + 0.5, clipped)."""
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: float = 1.0) -> np.ndarray:
    """Tile [N, H, W, C] images into one [gh, gw, C] float32 grid
    (torchvision-style), ``nrow`` images per row."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode_png(arr: np.ndarray) -> bytes:
    """PNG bytes of an [H, W] or [H, W, C] uint8 array, C in (1, 3, 4)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"save_image: expected uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"save_image: {c} channels (want 1, 3 or 4)")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),  # filter type 0 per row
                           np.ascontiguousarray(arr).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(img: np.ndarray, path: str) -> None:
    """Save [H, W, C] float [0,1] (or uint8) as a PNG file."""
    img = np.asarray(img)
    arr = img if img.dtype == np.uint8 else to_uint8(img)
    with open(path, "wb") as f:
        f.write(_encode_png(arr))


def save_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    save_image(make_grid(np.asarray(images), nrow=nrow), path)
