"""The port's DiT CLIs (``cli/train_dit.py``, ``cli/sample_dit.py``) on the
CPU (``--device cpu``, the plain PyTorch path).

- ``train_dit`` with the JAX smoke test's flags (DiT-S, the random tiny
  tokenizer at 64px, synthetic data: unconditional), its checkpoint,
  sidecar and ``history.jsonl``.
- ``--resume``: the step, the optimizer count and the sidecar carried over.
- The sidecar builds the JAX package's ``DiTConfig(**side['dit'])``.
- ``--vae_checkpoint``: the tokenizer's architecture comes from the
  checkpoint's ``config.json`` (a ``norm_latents=True`` tokenizer), not
  from ``--vae_variant``.
- ``--fid_every``: the best-FID checkpoint under ``best/`` with its
  ``metrics.json``, one FID row per evaluation.
- ``sample_dit`` end to end on a class-conditional run (an image folder of
  two classes): CFG 4, ``--classes``, EMA and live params, ``grid.png`` and
  one file per sample.

All but the smoke test use a micro tokenizer checkpoint (fp32, one block a
stage, ``norm_latents=True``) so that each run takes a few seconds.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from deepl_project_tpu.models import DiTConfig as JaxDiTConfig
from deepl_project_tpu.models import get_dit_config as jax_get_dit_config
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.cli import sample_dit, train_dit
from deepl_project_tpu_torch.models import DiTConfig, TransVAE, init_weights
from deepl_project_tpu_torch.training import latest_step, restore_checkpoint, save_checkpoint
from deepl_project_tpu_torch.utils.image import save_image

torch.set_num_threads(2)
TOKENIZER = dict(depths=(1, 1, 1, 1, 1), base_dims=(16, 16, 32, 32, 64), latent_dim=4,
                 head_dim=16, norm_latents=True, dtype="float32")


def _run(out, *extra, vae=None, steps=2):
    argv = ["--dit_variant", "S", "--vae_variant", "tiny", "--data", "synthetic",
            "--resolution", "64", "--batch_size", "2", "--total_steps", str(steps),
            "--log_every", "1", "--save_every", "0", "--sample_every", "0",
            "--stats_batches", "1", "--device", "cpu", "--output_dir", str(out)]
    if vae is not None:
        argv += ["--vae_checkpoint", vae]
    train_dit.main(argv + list(extra))


def _rows(out):
    return [json.loads(line) for line in open(os.path.join(out, "history.jsonl"))]


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    """A port tokenizer checkpoint (config.json + ckpt) whose architecture the
    flags alone do not give: five micro stages, latent_dim 4, norm_latents."""
    cfg = get_config("tiny", 16, 32).replace(**TOKENIZER)
    model = init_weights(TransVAE(cfg), torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("vae"))
    save_checkpoint(path, 1, {"model": model.state_dict(), "step": 1}, config=cfg)
    return path


def test_torch_train_dit_cli_smoke(tmp_path):
    _run(tmp_path)
    side = json.load(open(tmp_path / "dit_config.json"))
    assert side["unconditional"] and side["grid"] == 4 and side["dit"]["class_dropout"] == 1.0
    assert side["dit"]["hidden_dim"] == 384 and side["vae_checkpoint"] is None
    rows = _rows(tmp_path)
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite([r["loss"], r["grad_norm"], r["images_per_sec"]]).all() for r in rows)
    state, meta = restore_checkpoint(str(tmp_path))
    assert meta["step"] == 2 and state["state"]["step"] == 2
    assert set(state) == {"state", "latent_mean", "latent_std"}
    assert state["latent_std"].shape == (32,) and set(state["state"]) >= {"model", "ema"}


def test_torch_train_dit_cli_resume(tmp_path, tokenizer, capsys):
    _run(tmp_path, "--save_every", "1", vae=tokenizer, steps=1)
    side = open(tmp_path / "dit_config.json").read()
    first, _ = restore_checkpoint(str(tmp_path))
    # The resume names another --vae_variant: the sidecar keeps what it
    # recorded, and the checkpoint's latent statistics are the ones restored.
    _run(tmp_path, "--resume", "--vae_variant", "base", vae=tokenizer, steps=2)
    assert "resumed from step 1" in capsys.readouterr().out
    assert open(tmp_path / "dit_config.json").read() == side
    assert latest_step(str(tmp_path)) == 2
    state, _ = restore_checkpoint(str(tmp_path))
    assert state["state"]["step"] == 2 and state["state"]["optimizer"]["count"] == 2
    assert torch.equal(state["latent_mean"], first["latent_mean"])
    assert [r["step"] for r in _rows(tmp_path)] == [1, 2]


def test_torch_train_dit_sidecar_builds_the_jax_config(tmp_path, tokenizer):
    _run(tmp_path, "--plain_dit", "--patch_size", "1", "--num_classes", "7", vae=tokenizer,
         steps=1)
    side = json.load(open(tmp_path / "dit_config.json"))
    jcfg = JaxDiTConfig(**side["dit"])
    assert jcfg == jax_get_dit_config("S", 1, in_channels=4, num_classes=7, class_dropout=1.0,
                                      use_rmsnorm=False, use_swiglu=False, use_rope=False)
    assert DiTConfig(**side["dit"]) == DiTConfig(**vars(jcfg))
    state, _ = restore_checkpoint(str(tmp_path))
    assert state["state"]["model"]["pos_embed"].shape == (16, 384)  # 4x4 patches of 1


def test_torch_train_dit_cli_honours_the_vae_checkpoint_config(tmp_path, tokenizer, capsys):
    """The flags say tiny (latent_dim 32, no norm_latents); the checkpoint's
    config.json says otherwise, and wins: the micro tokenizer loads with
    strict=True and its latents (4 channels) have a bounded scale."""
    _run(tmp_path, vae=tokenizer, steps=1)
    log = capsys.readouterr().out
    m = re.search(r"mean\|max\|=([0-9.]+)", log)
    assert m and float(m.group(1)) < 100.0, log
    assert "random tokenizer" not in log and "on 4x4x4 latents" in log
    side = json.load(open(tmp_path / "dit_config.json"))
    assert side["vae_checkpoint"] == tokenizer and side["dit"]["in_channels"] == 4


def test_torch_train_dit_cli_best_fid_checkpoint(tmp_path, tokenizer):
    _run(tmp_path, "--fid_every", "1", "--fid_samples", "4", "--sample_steps", "2",
         "--sample_every", "2", vae=tokenizer)
    meta = json.load(open(tmp_path / "best" / "metrics.json"))
    (key,) = [k for k in meta if k.endswith("gen_fid")]
    assert key == "vgg_gen_fid" and np.isfinite(meta[key]) and meta[key] >= 0.0
    rows = _rows(tmp_path)
    fids = [r[key] for r in rows if r["kind"] == "fid"]
    assert len(fids) == 2 and meta[key] == pytest.approx(min(fids))
    assert latest_step(str(tmp_path / "best")) == meta["step"]
    assert os.path.exists(tmp_path / "samples_0000002.png")


def test_torch_sample_dit_cli_end_to_end(tmp_path, tokenizer, capsys):
    """A class-conditional run (a folder of two classes: labels 0 and 1),
    then sampling with CFG 4 from its EMA and its live params, the
    tokenizer given again through --vae_checkpoint."""
    folder = tmp_path / "images"
    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(folder / f"class_{c}")
        for i in range(2):
            save_image(rng.random((64, 64, 3), np.float32), str(folder / f"class_{c}" / f"{i}.png"))
    run = tmp_path / "run"
    _run(run, "--data", str(folder), "--num_classes", "2", vae=tokenizer, steps=1)
    assert not json.load(open(run / "dit_config.json"))["unconditional"]
    out = tmp_path / "samples"
    imgs = sample_dit.main(["--checkpoint", str(run), "--num_samples", "3", "--sample_steps",
                            "2", "--cfg_scale", "4", "--classes", "1,0",
                            "--vae_checkpoint", tokenizer, "--device", "cpu",
                            "--output_dir", str(out)])
    assert "ema params, cfg 4.0" in capsys.readouterr().out
    assert imgs.shape == (3, 64, 64, 3) and 0.0 <= imgs.min() <= imgs.max() <= 1.0
    assert sorted(os.listdir(out)) == ["grid.png", "sample_000_c1.png", "sample_001_c0.png",
                                       "sample_002_c1.png"]
    live = sample_dit.main(["--checkpoint", str(run), "--num_samples", "3", "--sample_steps",
                            "2", "--cfg_scale", "4", "--classes", "1,0", "--no-use_ema",
                            "--device", "cpu", "--vae_checkpoint", tokenizer,
                            "--output_dir", str(tmp_path / "live")])
    assert "live params" in capsys.readouterr().out and live.shape == imgs.shape
