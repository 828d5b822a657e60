"""Axial 2D rotary position embeddings (PyTorch port of ``ops/rope.py``).

The sin/cos tables are a function of (head_dim, H, W) only, so they are built
once per shape (float64 on the host, stored as float32 on the device) and
cached; modules hold no RoPE buffers, and the state_dict matches the
reference's with ``strict=True``.

Two pairings, as in the JAX package:

- ``'reference'`` (default) replicates the reference exactly: the second
  output of each pair takes its sin/cos from the *odd* table entries. The
  frequency layout is [y, y, x, x], so this is not a pure rotation, but
  reference checkpoints were trained with it.
- ``'standard'``: a true rotation (both outputs share the even-entry angle).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _rope2d_tables_np(head_dim: int, height: int, width: int):
    """(cos_a, sin_a, cos_b, sin_b), each [H*W, head_dim//2] float32; a/b are
    the even/odd entries of the interleaved frequency embedding."""
    assert head_dim % 4 == 0, "head_dim must be divisible by 4 for axial 2D RoPE"
    dim_axis = head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim_axis, 2, dtype=np.float64) / dim_axis))
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    y = yy.reshape(-1).astype(np.float64)
    x = xx.reshape(-1).astype(np.float64)
    y_freqs = np.outer(y, inv_freq)
    x_freqs = np.outer(x, inv_freq)
    emb = np.concatenate([y_freqs, y_freqs, x_freqs, x_freqs], axis=-1)
    a = emb[:, 0::2]
    b = emb[:, 1::2]
    f32 = np.float32
    return (np.cos(a).astype(f32), np.sin(a).astype(f32),
            np.cos(b).astype(f32), np.sin(b).astype(f32))


_DEVICE_TABLES: dict = {}


def rope2d_tables(head_dim: int, height: int, width: int,
                  pairing: str = "reference", device=None):
    """(cos_a, sin_a, cos_b, sin_b) as float32 tensors [H*W, head_dim//2] on
    ``device``, with the pairing applied ('standard' reuses the a-angles)."""
    if pairing not in ("reference", "standard"):
        raise ValueError(f"Unknown rope pairing: {pairing!r}")
    device = torch.device(device if device is not None else "cpu")
    key = (head_dim, height, width, pairing, device)
    tabs = _DEVICE_TABLES.get(key)
    if tabs is None:
        ca, sa, cb, sb = _rope2d_tables_np(head_dim, height, width)
        if pairing == "standard":
            cb, sb = ca, sa
        # Cached tables may be first built under inference_mode and later
        # saved for a backward: make them normal tensors either way.
        with torch.inference_mode(False):
            tabs = tuple(torch.from_numpy(t).to(device) for t in (ca, sa, cb, sb))
        _DEVICE_TABLES[key] = tabs
    return tabs


def apply_rope2d(x: torch.Tensor, height: int, width: int,
                 pairing: str = "reference", first_row: int = 0) -> torch.Tensor:
    """Apply the 2D rotary map to x [B, N, num_heads, head_dim], in float32;
    returns x's shape and dtype. x holds N = rows * W tokens of rows
    [first_row, first_row + rows) of a (height, width) grid: the whole grid
    by default; under context parallelism this rank's rows, whose table is
    the slice [first_row W, (first_row + rows) W) of the cached global one."""
    head_dim = x.shape[-1]
    rows = slice(first_row * width, first_row * width + x.shape[1])
    ca, sa, cb, sb = (t[rows, None, :] for t in rope2d_tables(
        head_dim, height, width, pairing, x.device))
    x32 = x.float()
    x1 = x32[..., 0::2]
    x2 = x32[..., 1::2]
    out1 = x1 * ca - x2 * sa
    out2 = x1 * sb + x2 * cb
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)
