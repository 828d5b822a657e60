"""Observability and the top-level API of the port, on the CPU.

- ``Trainer.fit`` writes TensorBoard scalars (tensorboardX) at the JAX
  trainer's points: each logged train row, each val row (under the train
  prefix, as JAX writes them) and the epoch averages, read back from the
  event file (TFRecord framing, ``Event`` protos; TensorBoard's own reader
  imports TensorFlow, seconds here) and compared with history.jsonl.
- ``MetricWriter`` against a stand-in ``tensorboardX`` (its calls
  recorded): scalars, an HWC image, flush and close, as the JAX writer
  makes them; nothing without a ``log_dir``, and off rank 0 only with
  ``only_primary=False``.
- ``DEEPL_DEBUG_NANS`` turns on autograd's anomaly mode for the run and
  restores it; ``profiler_trace`` writes a trace; ``StepTimer`` skips its
  warmup.
- ``from_pretrained``: the name parsed as the JAX function parses it, a bad
  name refused, the ``DEEPL_PRETRAINED_DIR`` registry and an explicit
  directory loaded, random weights from seed 0 otherwise.
- The pinned FLOP table equals the JAX package's; ``cli.smoke_test``'s
  six checks pass on the CPU.
"""

import json
import os
import struct
import sys
import types

import numpy as np
import pytest
import torch
from tensorboardX.proto.event_pb2 import Event

import deepl_project_tpu_torch
from deepl_project_tpu.models.transvae import from_pretrained as jax_from_pretrained
from deepl_project_tpu.utils import flops as jflops
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.cli import smoke_test
from deepl_project_tpu_torch.data import batch_iterator, make_dataset
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.training import Trainer, TrainerConfig
from deepl_project_tpu_torch.utils import flops
from deepl_project_tpu_torch.utils import logging as logging_mod
from deepl_project_tpu_torch.utils.logging import MetricWriter, StepTimer, profiler_trace

torch.set_num_threads(2)
# tiny_f8d16 at depth 1, narrow; latent_dim from the name (16).
MICRO = dict(depths=(1, 1, 1, 1), base_dims=(16, 16, 32, 64), head_dim=16,
             dtype="float32", use_dc_path=False)


def _trainer(out, **kw):
    tc = TrainerConfig(batch_size=2, warmup_steps=1, num_epochs=1, steps_per_epoch=2,
                       log_every=1, eval_every_steps=2, resolution=32, output_dir=str(out),
                       weights=LossWeights(gan=0.0, lpips=0.0), use_lpips=False,
                       save_every_epochs=1, seed=1, **kw)
    return Trainer(get_config("tiny_f8d16", **MICRO), tc, device="cpu")


def _fit(trainer):
    data = batch_iterator(make_dataset("shapes", resolution=32, num_samples=8), 2)
    val = list(batch_iterator(make_dataset("shapes", resolution=32, num_samples=2, seed=9), 2))
    return trainer.fit(data, val_batches=val)


def _scalars(path) -> dict:
    """tag -> [(step, value)] of a TensorBoard event file."""
    out: dict = {}
    with open(path, "rb") as f:
        while header := f.read(12):  # uint64 length, uint32 masked crc
            (n,) = struct.unpack("<Q", header[:8])
            event = Event.FromString(f.read(n))
            f.read(4)
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out


def test_fit_writes_tensorboard_scalars(tmp_path):
    _fit(_trainer(tmp_path))
    rows = [json.loads(line) for line in open(tmp_path / "history.jsonl")]
    (event_file,) = os.listdir(tmp_path / "tb")
    scalars = _scalars(tmp_path / "tb" / event_file)

    train = [r for r in rows if r["kind"] == "train"]
    (val,) = [r for r in rows if r["kind"] == "val"]
    assert [r["step"] for r in train] == [1, 2] and val["step"] == 2
    for key in ("total", "l1", "kl", "grad_norm", "images_per_sec"):
        assert scalars[f"train/{key}"] == [(r["step"], pytest.approx(r[key], rel=1e-6))
                                          for r in train]
    for key in ("val_psnr", "val_ssim"):
        assert scalars[f"train/{key}"] == [(2, pytest.approx(val[key], rel=1e-6))]
    assert scalars["train/epoch_avg/total"] == [
        (2, pytest.approx(np.mean([r["total"] for r in train]), rel=1e-6))]
    keys = [k for k in train[0] if k not in ("step", "kind", "ts")]
    assert set(scalars) == ({f"train/{k}" for k in keys} | {f"train/epoch_avg/{k}" for k in keys}
                    | {"train/val_psnr", "train/val_ssim"})


def test_metric_writer_calls_the_summary_writer_as_jax_does(tmp_path, monkeypatch):
    calls = []

    class SummaryWriter:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def __getattr__(self, name):
            return lambda *args, **kw: calls.append((name, args, kw))

    monkeypatch.setitem(sys.modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=SummaryWriter))
    image = np.zeros((4, 6, 3), np.uint8)
    writer = MetricWriter(str(tmp_path))
    writer.scalars(3, {"loss": np.float32(0.5)}, prefix="val")
    writer.image(3, "recon", image)
    writer.flush()
    writer.close()
    assert calls[:2] == [("init", str(tmp_path)), ("add_scalar", ("val/loss", 0.5, 3), {})]
    (name, args, kw), *rest = calls[2:]
    assert name == "add_image" and args[0] == "recon" and args[1] is image
    assert args[2] == 3 and kw == {"dataformats": "HWC"}
    assert [c[0] for c in rest] == ["flush", "close"]
    # No log_dir: no writer, every call a no-op.
    calls.clear()
    quiet = MetricWriter(None)
    quiet.scalars(1, {"a": 1.0})
    quiet.image(1, "x", image)
    quiet.flush()
    quiet.close()
    assert calls == []
    # Off rank 0: nothing unless only_primary=False.
    monkeypatch.setattr(logging_mod, "is_primary", lambda: False)
    MetricWriter(str(tmp_path)).scalars(1, {"a": 1.0})
    assert calls == []
    MetricWriter(str(tmp_path), only_primary=False).flush()
    assert [c[0] for c in calls] == ["init", "flush"]


def test_debug_nans_turns_on_anomaly_mode(tmp_path, monkeypatch):
    seen = []
    trainer = _trainer(tmp_path)
    step_fn = trainer.step_fn

    def spy(state, batch):
        seen.append(torch.is_anomaly_enabled())
        return step_fn(state, batch)

    trainer.step_fn = spy
    monkeypatch.setenv("DEEPL_DEBUG_NANS", "1")
    _fit(trainer)
    assert seen == [True, True] and not torch.is_anomaly_enabled()
    monkeypatch.delenv("DEEPL_DEBUG_NANS")
    seen.clear()
    trainer = _trainer(tmp_path / "plain")
    step_fn = trainer.step_fn
    trainer.step_fn = spy
    _fit(trainer)
    assert seen == [False, False]


def test_profiler_trace_and_step_timer(tmp_path):
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (trace,) = os.listdir(tmp_path / "trace")
    assert trace.endswith(".pt.trace.json")
    assert "traceEvents" in json.load(open(tmp_path / "trace" / trace))
    timer = StepTimer(warmup=2)
    timer.tick(8)
    timer.tick(8)
    assert timer.images_per_sec == 0.0  # the warmup's ticks count no images
    timer.tick(8)
    assert timer.images_per_sec > 0


def test_from_pretrained(tmp_path, monkeypatch):
    monkeypatch.delenv("DEEPL_PRETRAINED_DIR", raising=False)
    name = "transvae-tiny-f8d16"
    kw = dict(device="cpu", **MICRO)
    model = deepl_project_tpu_torch.from_pretrained(name, **kw)
    jax_model, jax_params = jax_from_pretrained(name, **MICRO)
    assert jax_params is None and model.config == get_config("tiny", 8, 16, **MICRO)
    assert model.config.compression_ratio == jax_model.config.compression_ratio == 8
    assert model.config.latent_dim == jax_model.config.latent_dim == 16
    again = deepl_project_tpu_torch.from_pretrained(name, **kw)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))  # seed 0
    for bad in ("transvae", "transvae-tiny"):
        with pytest.raises(ValueError, match="Bad model name"):
            deepl_project_tpu_torch.from_pretrained(bad, device="cpu")

    # A trainer checkpoint, by explicit directory and through the registry.
    trainer = _trainer(tmp_path / "run")
    state = trainer.create_state()
    trainer.save(state, epoch=0)
    ckpt = str(tmp_path / "run" / "checkpoints")
    want = state.model.state_dict()
    os.makedirs(tmp_path / "registry")
    os.symlink(ckpt, tmp_path / "registry" / name)
    monkeypatch.setenv("DEEPL_PRETRAINED_DIR", str(tmp_path / "registry"))
    for loaded in (deepl_project_tpu_torch.from_pretrained(name, checkpoint_dir=ckpt, **kw),
                   deepl_project_tpu_torch.from_pretrained(name, **kw)):
        got = loaded.state_dict()
        assert not loaded.training and all(torch.equal(got[k], want[k]) for k in want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            deepl_project_tpu_torch.from_pretrained(name)


def test_flops_table_and_smoke_cli(capsys):
    assert flops.REFERENCE_TFLOPS_PER_IMAGE == jflops.REFERENCE_TFLOPS_PER_IMAGE
    assert flops.reference_flops_per_image("large") == jflops.reference_flops_per_image("large")
    with pytest.raises(KeyError):
        flops.reference_flops_per_image("large", res=384)
    assert smoke_test.main(["--device", "cpu"]) == 0
    assert "6/6 checks passed" in capsys.readouterr().out
