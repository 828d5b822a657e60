"""Dataset sources (PyTorch port of ``data/datasets.py``): plain iterators
of HWC float32 [0, 1] numpy images, or of ``(image, label)`` pairs with
``with_labels``.

- ``synthetic`` / ``shapes``: drawn from the same numpy generator calls as
  the JAX package's, so a seed gives the same bytes in both.
- A folder of images (torchvision ImageFolder semantics: recursive, sorted,
  labels from the top-level class directories), shuffled per epoch with
  ``random.Random(seed + epoch)``, sharded ``files[index::num_shards]``.
- A COCO root (``annotations/instances_<split>.json``, or the sorted
  listing of ``<split>/`` without it); never shuffled, as in JAX.
- ``hf:<name>``: a Hugging Face streaming split, sharded, then shuffled in a
  buffer (needs the ``datasets`` package and the hub).

``keep`` (a predicate on a sample's 0-based position in the stream,
``pipeline.row_filter``) keeps one data rank's rows of every global batch:
the synthetic sources draw every sample and yield the kept ones; the folder
and COCO sources drop the others before decoding them (a file that turns
out unreadable then leaves its row to the rank's next file).

Files decode with the native C++ decoder (``native_loader``) where it
builds, else with PIL, as the JAX package chooses; unreadable files are
skipped. Where neither decoder is present the folder and COCO sources
raise at once, where the JAX package's would skip every file.
"""

from __future__ import annotations

import json
import os
import random
from typing import Iterator

import numpy as np

from .transforms import pil_available, preprocess_file, preprocess_image

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


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


def _require_decoder() -> None:
    from . import native_loader

    if not (native_loader.native_available() or pil_available()):
        raise RuntimeError(
            "no image decoder: the native decoder (native/image_loader.cpp) did not "
            f"build or load ({native_loader.build_error()}) and PIL (Pillow) is not "
            "installed")


def _iter_decoded(files: list[str], resolution: int, num_workers: int,
                  label_of=None):
    """Decode an ordered path list; images, or (image, label) with
    ``label_of``. Unreadable files are skipped.

    ``num_workers > 0`` decodes in parallel: the native decoder runs
    ``decode_batch`` chunks on its own threads with the next chunk in
    flight; PIL maps over a thread pool (its decode releases the GIL)."""
    from . import native_loader

    native = native_loader.native_available()
    if num_workers <= 0:
        for path in files:
            if native:
                sample = native_loader.decode_file(path, resolution)
            else:
                try:
                    sample = preprocess_file(path, resolution)
                except Exception:  # noqa: BLE001 -- an unreadable file is skipped
                    sample = None
            if sample is None:
                continue
            yield (sample, label_of(path)) if label_of else sample
        return

    from concurrent.futures import ThreadPoolExecutor

    if native:
        chunk_size = max(num_workers * 4, 16)
        chunks = [files[i:i + chunk_size] for i in range(0, len(files), chunk_size)]
        with ThreadPoolExecutor(max_workers=1) as ex:  # one chunk in flight
            pending = None
            for nxt in chunks + [None]:
                fut = (ex.submit(native_loader.decode_batch, nxt, resolution, num_workers)
                       if nxt is not None else None)
                if pending is not None:
                    (batch, ok), paths = pending[0].result(), pending[1]
                    for img, good, path in zip(batch, ok, paths):
                        if good:
                            yield (img, label_of(path)) if label_of else img
                pending = (fut, nxt)
    else:
        def decode_one(path):
            try:
                return path, preprocess_file(path, resolution)
            except Exception:  # noqa: BLE001 -- an unreadable file is skipped
                return path, None

        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            for path, img in ex.map(decode_one, files, chunksize=4):
                if img is not None:
                    yield (img, label_of(path)) if label_of else img


def list_images(root: str) -> list[str]:
    """Every image file under ``root``, recursively, sorted by path."""
    files = []
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if n.lower().endswith(IMAGE_EXTENSIONS):
                files.append(os.path.join(dirpath, n))
    files.sort()
    return files


def folder_class_index(root: str) -> dict[str, int]:
    """ImageFolder class mapping: sorted immediate subdirectories of root."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    return {c: i for i, c in enumerate(classes)}


def _kept(files: list, keep, start: int) -> list:
    return files if keep is None else [f for k, f in enumerate(files, start) if keep(k)]


def image_folder_dataset(root: str, resolution: int = 256, shuffle: bool = True,
                         seed: int = 42, shard_index: int | None = None,
                         num_shards: int | None = None, repeat: bool = False,
                         with_labels: bool = False, num_workers: int = 0,
                         keep=None) -> Iterator:
    """Images under ``root`` (recursive). With ``with_labels`` each item is
    ``(image, label)``, label the index of its top-level class directory
    (-1 for an image not under one). Each epoch's order is the sorted list
    shuffled by ``random.Random(seed + epoch)``; a shard takes every
    ``num_shards``-th file from ``shard_index``."""
    files = list_images(root)
    if not files:
        raise FileNotFoundError(f"No images under {root}")
    class_to_idx = folder_class_index(root) if with_labels else {}

    def label_of(path: str) -> int:
        head = os.path.relpath(path, root).split(os.sep, 1)[0]
        return class_to_idx.get(head, -1)

    if num_shards and num_shards > 1:
        files = files[(shard_index or 0)::num_shards]
    _require_decoder()
    epoch = 0
    while True:
        order = list(files)
        if shuffle:
            random.Random(seed + epoch).shuffle(order)
        yield from _iter_decoded(_kept(order, keep, epoch * len(files)), resolution,
                                 num_workers, label_of if with_labels else None)
        epoch += 1
        if not repeat:
            return


def coco_dataset(root: str, resolution: int = 256, split: str = "train2017",
                 max_samples: int | None = None, shard_index: int | None = None,
                 num_shards: int | None = None, num_workers: int = 0,
                 repeat: bool = False, keep=None) -> Iterator[np.ndarray]:
    """COCO images of ``split``, in the annotation file's order (or sorted
    by name without it); no shuffle."""
    ann_path = os.path.join(root, "annotations", f"instances_{split}.json")
    img_dir = os.path.join(root, split)
    if os.path.exists(ann_path):
        with open(ann_path) as f:
            names = [img["file_name"] for img in json.load(f)["images"]]
    else:
        names = sorted(n for n in os.listdir(img_dir) if n.lower().endswith(IMAGE_EXTENSIONS))
    if max_samples:
        names = names[:max_samples]
    if num_shards and num_shards > 1:
        names = names[(shard_index or 0)::num_shards]
    files = [os.path.join(img_dir, name) for name in names]
    _require_decoder()
    epoch = 0
    while True:
        yield from _iter_decoded(_kept(files, keep, epoch * len(files)), resolution,
                                 num_workers)
        epoch += 1
        if not repeat:
            return


def _pipelined_map(fn, iterable, num_workers: int) -> Iterator:
    """Order-preserving thread-pool map with at most ``2 * num_workers``
    items in flight, so an unbounded stream is never drained eagerly."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    depth = num_workers * 2
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        window = deque()
        for item in iterable:
            window.append(ex.submit(fn, item))
            if len(window) >= depth:
                yield window.popleft().result()
        while window:
            yield window.popleft().result()


def hf_streaming_dataset(name: str = "evanarlian/imagenet_1k_resized_256",
                         split: str = "train", resolution: int = 256,
                         shuffle_buffer: int = 10_000, seed: int = 42,
                         shard_index: int | None = None,
                         num_shards: int | None = None, with_labels: bool = False,
                         num_workers: int = 0) -> Iterator:
    """A Hugging Face streaming split: sharded, then shuffled in a buffer of
    ``shuffle_buffer`` (0: not shuffled); examples without an image are
    skipped. Needs the ``datasets`` package and access to the hub."""
    from datasets import load_dataset

    ds = load_dataset(name, split=split, streaming=True)
    if num_shards and num_shards > 1:
        ds = ds.shard(num_shards=num_shards, index=shard_index or 0)
    if shuffle_buffer:
        ds = ds.shuffle(seed=seed, buffer_size=shuffle_buffer)

    def decode(example):
        img = example.get("image") or example.get("img")
        if img is None:
            return None
        out = preprocess_image(img, resolution)
        return (out, int(example.get("label", -1))) if with_labels else out

    it = _pipelined_map(decode, ds, num_workers) if num_workers > 0 else map(decode, ds)
    return (s for s in it if s is not None)


def _with_dummy_labels(it: Iterator[np.ndarray]) -> Iterator:
    for sample in it:
        yield sample, -1


def make_dataset(source: str, resolution: int = 256, with_labels: bool = False,
                 **kw) -> Iterator:
    """By ``source``: 'synthetic' / 'shapes' (``num_samples``, ``seed``),
    'hf:<name>', a COCO root (a path with an ``annotations`` directory) or
    an image folder. Each drops the keywords it has no use for, as the JAX
    dispatch does. With ``with_labels`` every item is ``(image, label)``;
    the synthetic and COCO sources label every image -1 (unlabeled)."""
    if source in ("synthetic", "shapes"):
        for key in ("shard_index", "num_shards", "num_workers"):
            kw.pop(key, None)
        keep = kw.pop("keep", None)
        fn = synthetic_dataset if source == "synthetic" else synthetic_shapes_dataset
        it = fn(resolution, **kw)
        if keep is not None:
            it = (x for k, x in enumerate(it) if keep(k))
        return _with_dummy_labels(it) if with_labels else it
    if source.startswith("hf:"):
        kw.pop("repeat", None)
        if kw.pop("keep", None) is not None:
            raise ValueError("an hf: source splits by ds.shard (shard_index, num_shards), "
                             "not by rows")
        return hf_streaming_dataset(source[3:], resolution=resolution,
                                    with_labels=with_labels, **kw)
    if os.path.isdir(os.path.join(source, "annotations")):
        it = coco_dataset(source, resolution=resolution, **kw)
        return _with_dummy_labels(it) if with_labels else it
    return image_folder_dataset(source, resolution=resolution, with_labels=with_labels, **kw)
