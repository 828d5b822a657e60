"""The port's data sources against the JAX package's, on the CPU.

A tmp tree of PNG and JPEG files of mixed sizes (class directories, a
nested directory, loose images, an unreadable file and a non-image) goes
through both packages' ``image_folder_dataset``, ``coco_dataset`` (with
and without its annotation file) and ``make_dataset``, each decoder forced
in both packages in turn: the native C++ decoder (``native/image_loader.cpp``,
built by each package into its own library with the same flags) and PIL.
Images must be bit-equal, with the same labels in the same order, for two
seeds, two epochs under ``repeat`` and two shards. The ``hf:`` source runs on a
stand-in ``datasets`` module, as the JAX package's own test feeds it.
Parallel decode must equal serial decode; ``batch_iterator`` and
``input_pipeline`` carry labels; with no decoder the sources raise.
"""

import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import deepl_project_tpu.data.datasets as jds
import deepl_project_tpu.data.native_loader as jnative
import deepl_project_tpu_torch.data.datasets as pds
import deepl_project_tpu_torch.data.native_loader as pnative
from deepl_project_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from deepl_project_tpu_torch.data import batch_iterator, input_pipeline

torch.set_num_threads(2)
RES = 16
CLASSES = ("cat", "dog", "eel", "fox")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """An ImageFolder tree: 4 classes (one with a nested directory), loose
    images, PNG (RGB and greyscale) and JPEG of mixed sizes, an unreadable
    .jpg and a .txt."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.RandomState(0)
    sizes = ((37, 29), (24, 40), (30, 30), (41, 23))
    n = 0
    for c in CLASSES:
        os.makedirs(root / c / "deep")
        for i in range(3):
            h, w = sizes[(n + i) % 4]
            arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            sub = root / c / "deep" if i == 2 and c == "dog" else root / c
            if i == 1:
                Image.fromarray(arr).save(sub / f"{c}{i}.jpg", quality=90)
            else:
                Image.fromarray(arr).save(sub / f"{c}{i}.png")
        n += 1
    Image.fromarray((rng.rand(33, 27) * 255).astype(np.uint8), "L").save(root / "loose_grey.png")
    Image.fromarray((rng.rand(26, 35, 3) * 255).astype(np.uint8)).save(root / "loose.jpg")
    (root / "cat" / "broken.jpg").write_bytes(b"not an image")
    (root / "notes.txt").write_text("skipped")
    return str(root)


@pytest.fixture(scope="module")
def coco(tmp_path_factory, tree):
    """Two COCO roots over the same images: one with
    annotations/instances_val2017.json (an unsorted order), one without."""
    out = {}
    names = [n for c in ("cat", "fox") for n in sorted(os.listdir(os.path.join(tree, c)))
             if n != "deep"]
    for kind in ("annotated", "listed"):
        root = tmp_path_factory.mktemp(kind)
        os.makedirs(root / "val2017")
        os.makedirs(root / "annotations")
        for i, n in enumerate(names):
            src = os.path.join(tree, "cat" if n.startswith(("cat", "broken")) else "fox", n)
            shutil.copy(src, root / "val2017" / f"{i:02d}_{n}")
        if kind == "annotated":
            files = sorted(os.listdir(root / "val2017"), reverse=True)
            with open(root / "annotations" / "instances_val2017.json", "w") as f:
                json.dump({"images": [{"file_name": n} for n in files]}, f)
        out[kind] = str(root)
    return out


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    """Force one decoder in both packages."""
    if request.param == "pil":
        monkeypatch.setattr(jnative, "native_available", lambda: False)
        monkeypatch.setattr(pnative, "native_available", lambda: False)
    else:
        if jnative._lib is None:  # a worker that lost the build race at collection
            monkeypatch.setattr(jnative, "_tried", False)
        assert jnative.native_available(), "the JAX package's native decoder did not load"
        assert pnative.native_available(), pnative.build_error()
    return request.param


def _same(ours, theirs):
    """Bit-equal images (or (image, label) items) in the same order."""
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        if isinstance(b, tuple):
            assert a[1] == b[1]
            a, b = a[0], b[0]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (RES, RES, 3)
        assert a.tobytes() == b.tobytes()
    return ours


def _take(it, n):
    return [x for _, x in zip(range(n), it)]


@pytest.mark.parametrize("seed", [42, 7])
def test_folder_matches_jax(tree, decoder, seed):
    """Labels, order and pixels, for one seed: one pass, two epochs under
    repeat, each of two shards."""
    kw = dict(resolution=RES, seed=seed, with_labels=True)
    items = _same(pds.image_folder_dataset(tree, **kw), jds.image_folder_dataset(tree, **kw))
    assert len(items) == 14  # 12 in class dirs + 2 loose; broken.jpg skipped
    labels = sorted(label for _, label in items)
    assert labels == [-1, -1] + [i for i in range(4) for _ in range(3)]
    two = _same(_take(pds.image_folder_dataset(tree, repeat=True, **kw), 28),
                _take(jds.image_folder_dataset(tree, repeat=True, **kw), 28))
    assert [x[1] for x in two[:14]] != [x[1] for x in two[14:]]  # epoch 1 reshuffled
    for index in (0, 1):
        shard = dict(kw, num_shards=2, shard_index=index)
        _same(pds.image_folder_dataset(tree, **shard), jds.image_folder_dataset(tree, **shard))


def test_folder_parallel_decode_and_unlabeled(tree, decoder):
    serial = list(pds.image_folder_dataset(tree, RES, seed=3))
    for workers in (1, 3):
        _same(pds.image_folder_dataset(tree, RES, seed=3, num_workers=workers), serial)
        _same(pds.image_folder_dataset(tree, RES, seed=3, num_workers=workers),
              jds.image_folder_dataset(tree, RES, seed=3, num_workers=workers))
    _same(pds.image_folder_dataset(tree, RES, shuffle=False),
          jds.image_folder_dataset(tree, RES, shuffle=False))
    assert pds.folder_class_index(tree) == jds.folder_class_index(tree) == {
        c: i for i, c in enumerate(CLASSES)}


@pytest.mark.parametrize("kind", ["annotated", "listed"])
def test_coco_matches_jax(coco, decoder, kind):
    root = coco[kind]
    _same(pds.coco_dataset(root, RES, split="val2017"),
          jds.coco_dataset(root, RES, split="val2017"))
    kw = dict(resolution=RES, split="val2017", max_samples=5, num_shards=2, shard_index=1,
              repeat=True, num_workers=2)
    _same(_take(pds.coco_dataset(root, **kw), 6), _take(jds.coco_dataset(root, **kw), 6))


def test_make_dataset_dispatch_matches_jax(tree, coco, decoder):
    _same(pds.make_dataset(tree, RES, with_labels=True, seed=5, num_workers=2),
          jds.make_dataset(tree, RES, with_labels=True, seed=5, num_workers=2))
    kw = dict(split="val2017", with_labels=True)
    coco_items = _same(pds.make_dataset(coco["listed"], RES, **kw),
                       jds.make_dataset(coco["listed"], RES, **kw))
    assert {label for _, label in coco_items} == {-1}
    for src in ("synthetic", "shapes"):
        kw = dict(num_samples=3, seed=2, with_labels=True, num_workers=4, num_shards=2)
        _same(pds.make_dataset(src, RES, **kw), jds.make_dataset(src, RES, **kw))


class _FakeStream:
    """A streaming split of the stand-in ``datasets`` module."""

    def __init__(self, examples):
        self.examples = examples
        self.shard_args = self.shuffle_args = None

    def shard(self, num_shards, index):
        self.shard_args = (num_shards, index)
        return _FakeStream(self.examples[index::num_shards])

    def shuffle(self, seed, buffer_size):
        self.shuffle_args = (seed, buffer_size)
        return self

    def __iter__(self):
        return iter(self.examples)


def _fake_datasets(monkeypatch, examples):
    calls = {}
    streams = []

    def load_dataset(name, split, streaming):
        calls.update(name=name, split=split, streaming=streaming)
        streams.append(_FakeStream(examples))
        return streams[-1]

    mod = types.ModuleType("datasets")
    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)
    return calls, streams


def test_hf_stream_matches_jax(monkeypatch):
    rng = np.random.RandomState(1)
    examples = [{"image": Image.fromarray((rng.rand(12 + i, 20, 3) * 255).astype(np.uint8)),
                 "label": i % 3} for i in range(8)]
    examples.insert(3, {"label": 9})  # no image: skipped
    calls, streams = _fake_datasets(monkeypatch, examples)
    kw = dict(resolution=RES, shuffle_buffer=4, with_labels=True)
    items = _same(pds.hf_streaming_dataset("org/name", **kw),
                  jds.hf_streaming_dataset("org/name", **kw))
    assert calls == {"name": "org/name", "split": "train", "streaming": True}
    assert streams[0].shuffle_args == streams[1].shuffle_args == (42, 4)
    assert [label for _, label in items] == [i % 3 for i in range(8)]
    kw = dict(resolution=RES, shuffle_buffer=0, num_shards=2, shard_index=1)
    serial = _same(pds.make_dataset("hf:d", repeat=True, **kw),
                   jds.make_dataset("hf:d", repeat=True, **kw))
    assert len(serial) == 3  # examples 1, 5, 7 of the nine (3 has no image)
    _same(pds.make_dataset("hf:d", num_workers=3, **kw), serial)


def _tree_bytes(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("max_images", [None, 3])
def test_download_cli_writes_the_jax_tree(monkeypatch, tmp_path, capsys, max_images):
    """cli.download of both packages on the same stand-in ``datasets``
    stream (RGB and grayscale images under 'image' or 'img', one example
    without an image, labels 0-2 and one without a label): the same
    class-folder tree of JPEGs, byte for byte, and the same output."""
    from deepl_project_tpu.cli import download as jax_download
    from deepl_project_tpu_torch.cli import download

    rng = np.random.RandomState(2)
    examples = []
    for i in range(6):
        img = Image.fromarray((rng.rand(10 + i, 14, 3) * 255).astype(np.uint8))
        examples.append({"image" if i % 2 else "img": img.convert("L") if i == 4 else img,
                         "label": i % 3})
    examples.insert(2, {"label": 1})  # no image: skipped
    examples.append({"image": Image.fromarray(np.zeros((8, 8, 3), np.uint8))})  # label 0
    calls, _ = _fake_datasets(monkeypatch, examples)
    trees, printed = [], []
    for i, cli in enumerate((download, jax_download)):
        out = tmp_path / str(i)
        argv = ["--dataset", "org/images", "--split", "validation", "--out", str(out)]
        cli.main(argv + ([] if max_images is None else ["--max_images", str(max_images)]))
        assert calls == {"name": "org/images", "split": "validation", "streaming": True}
        trees.append(_tree_bytes(out))
        printed.append(capsys.readouterr().out.replace(str(out), "OUT"))
    assert trees[0] == trees[1] and printed[0] == printed[1]
    assert len(trees[0]) == (7 if max_images is None else max_images)
    assert all(k.endswith(".jpg") and k.startswith("class_000") for k in trees[0])


def test_batches_carry_labels(tree):
    items = list(pds.image_folder_dataset(tree, RES, with_labels=True))
    ours = list(batch_iterator(iter(items), 4, drop_last=False))
    theirs = list(jax_batch_iterator(iter(items), 4, drop_last=False))
    assert len(ours) == len(theirs) == 4
    for (x, y), (jx, jy) in zip(ours, theirs):
        assert x.tobytes() == jx.tobytes() and y.dtype == jy.dtype == np.int32
        assert np.array_equal(y, jy)
    mapped = list(batch_iterator(iter(range(10)), 3, num_workers=4,
                                 sample_fn=lambda i: (np.full((2, 2, 3), i, np.float32), i)))
    assert [b[1].tolist() for b in mapped] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    on_device = list(input_pipeline(iter(items), 4, "cpu"))
    assert len(on_device) == 3
    for (x, y), (wx, wy) in zip(on_device, ours):
        assert isinstance(x, torch.Tensor) and y.dtype == torch.int32
        assert np.array_equal(x.numpy(), wx) and np.array_equal(y.numpy(), wy)


def test_no_decoder_raises(tree, coco, monkeypatch):
    monkeypatch.setattr(pnative, "native_available", lambda: False)
    monkeypatch.setattr(pds, "pil_available", lambda: False)
    for it in (pds.image_folder_dataset(tree, RES, repeat=True),
               pds.make_dataset(coco["listed"], RES, split="val2017", repeat=True)):
        with pytest.raises(RuntimeError, match="no image decoder"):
            next(it)


def test_native_library_builds_into_the_port(tmp_path):
    """The port's library is its own build under csrc/build/, and its batch
    decode of a folder equals its file decode."""
    assert pnative.native_available(), pnative.build_error()
    assert pnative._lib_path().parent == pnative.BUILD_DIR
    rng = np.random.RandomState(2)
    for i in range(5):
        Image.fromarray((rng.rand(30 + i, 25, 3) * 255).astype(np.uint8)).save(
            tmp_path / f"{i}.png")
    files = pds.list_images(str(tmp_path))
    batch, ok = pnative.decode_batch(files + [str(tmp_path / "missing.png")], RES, 3)
    assert ok.tolist() == [True] * 5 + [False] and not batch[5].any()
    for img, f in zip(batch, files):
        assert img.tobytes() == pnative.decode_file(f, RES).tobytes()
    batches = list(pnative.native_folder_batches(str(tmp_path), RES, batch_size=2))
    theirs = list(jnative.native_folder_batches(str(tmp_path), RES, batch_size=2))
    assert [b.shape for b in batches] == [(2, RES, RES, 3)] * 2
    assert all(a.tobytes() == b.tobytes() for a, b in zip(batches, theirs))
