"""The port's stage-1 training path against the JAX package's, on the CPU.

- The optimizer against ``make_optimizer`` (optax) step for step on a small
  param tree: warmup, global-norm clip, a NaN step, ``freeze_encoder``,
  ``mu_dtype='bfloat16'``; and the schedules against optax's.
- A micro TransVAE's loss and gradients (``sample=False``, L1 + KL, fp32)
  against ``jax.value_and_grad`` of the JAX loss on converted weights, with
  ``attention_impl='auto_train'``.
- Gradient accumulation against the full batch, ``reparameterize`` with a
  given noise, ``Trainer.fit`` with a checkpoint and a resume, the train
  CLI's refusals, and the interop of checkpoints and synthetic data with the
  JAX package.

Tolerances: optimizer and schedules 1e-6 relative (fp32, other operation
order); model loss 1e-5 relative and gradients 1e-4 x the largest gradient
entry (fp32 through four stages, sums in other orders; a bias ahead of a
norm has a gradient of rounding noise only); accumulation 1e-5 x the same.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.data import synthetic_dataset as jax_synthetic
from deepl_project_tpu.data.datasets import synthetic_shapes_dataset as jax_shapes
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.losses.vae_loss import transvae_loss as jax_transvae_loss
from deepl_project_tpu.training.optim import make_optimizer as jax_make_optimizer
from deepl_project_tpu.training.schedule import warmup_constant as jax_warmup_constant
from deepl_project_tpu.training.schedule import warmup_cosine as jax_warmup_cosine
from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.cli import train as train_cli
from deepl_project_tpu_torch.data import batch_iterator, make_dataset
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.models import TransVAE, init_weights
from deepl_project_tpu_torch.training import (Trainer, TrainerConfig, latest_step,
                                              load_config, make_optimizer,
                                              restore_checkpoint, warmup_constant,
                                              warmup_cosine)
from deepl_project_tpu_torch.training.train_step import compute_grads
from deepl_project_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(2)
# 4 stages (2 CNN, 2 transformer) without the DC shortcut path: the JAX
# gradient's trace and compile stay a few seconds (the DC path's forward is
# held to JAX in test_torch_model.py).
MICRO = dict(depths=(1, 1, 1, 1), base_dims=(16, 16, 32, 64), latent_dim=4,
             head_dim=16, dtype="float32", attention_impl="auto_train", use_dc_path=False)
VARIANT = "tiny_f8d16"


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


# -- optimizer ---------------------------------------------------------------
def _param_tree(rng):
    f = np.float32
    return {"model": {"encoder": {"w": rng.standard_normal((4, 3)).astype(f)},
                      "decoder": {"w": rng.standard_normal(3).astype(f),
                                  "b": rng.standard_normal((2, 2)).astype(f)}}}


def _named(tree):
    m = tree["model"]
    return [("encoder.w", m["encoder"]["w"]), ("decoder.w", m["decoder"]["w"]),
            ("decoder.b", m["decoder"]["b"])]


@pytest.mark.parametrize("freeze,mu_dtype", [(False, None), (True, "bfloat16")])
def test_optimizer_matches_optax(freeze, mu_dtype):
    rng = np.random.default_rng(0)
    params = _param_tree(rng)
    # Five steps: two above the clip norm, one NaN (skipped), warmup 3.
    scales = [5.0, 0.1, 1.0, 3.0, 0.2]
    grads = [jax.tree_util.tree_map(lambda p, s=s: (s * rng.standard_normal(p.shape)).astype(
        np.float32), params) for s in scales]
    grads[2]["model"]["decoder"]["w"][1] = np.nan
    kw = dict(learning_rate=0.05, warmup_steps=3, max_grad_norm=1.0,
              freeze_encoder=freeze, mu_dtype=mu_dtype)
    tx = jax_make_optimizer(**kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    tensors = [(n, torch.from_numpy(p.copy())) for n, p in _named(params)]
    opt = make_optimizer(tensors, **kw)
    for i, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step([torch.from_numpy(a.copy()) for _, a in _named(g)])
        assert applied == (i != 2)
        for (name, t), (_, want) in zip(tensors, _named(jparams)):
            _close(t.numpy(), want, rtol=1e-6, atol=1e-7)
    assert opt.count == 4 and opt.total_notfinite == 1 and opt.notfinite_count == 0
    if freeze:
        np.testing.assert_array_equal(tensors[0][1].numpy(), params["model"]["encoder"]["w"])
        assert opt.mu[0] is None and opt.mu[1].dtype == torch.bfloat16


def test_schedules_match_optax():
    for ours, theirs in ((warmup_constant(1e-4, 10), jax_warmup_constant(1e-4, 10)),
                         (warmup_constant(1e-4, 0), jax_warmup_constant(1e-4, 0)),
                         (warmup_cosine(1e-4, 5, 40, 0.1), jax_warmup_cosine(1e-4, 5, 40, 0.1)),
                         (warmup_cosine(2e-4, 0, 20), jax_warmup_cosine(2e-4, 0, 20))):
        for count in (0, 1, 4, 5, 9, 10, 17, 40, 55):
            _close(ours(count), float(theirs(count)), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer([("w", torch.zeros(2))], optimizer="adagrad")


# -- model loss and gradients ---------------------------------------------------
@pytest.fixture(scope="module")
def micro_pair():
    """(port model, JAX model, JAX params) on the same weights."""
    cfg = get_config(VARIANT, **MICRO)
    src = TransVAE(cfg, device="cpu")
    init_weights(src, torch.Generator().manual_seed(0))
    params = torch_state_dict_to_params({k: v.numpy() for k, v in src.state_dict().items()},
                                        jax_get_config(VARIANT, **MICRO))
    port = TransVAE(cfg, device="cpu")
    load_jax_params(port, params)
    return port, JaxTransVAE(jax_get_config(VARIANT, **MICRO)), params


def test_micro_model_loss_and_grads_match_jax(micro_pair):
    port, jm, params = micro_pair
    batch = np.random.default_rng(4).random((2, 16, 16, 3), dtype=np.float32)
    jw = JaxLossWeights(l1=1.0, lpips=0.0, kl=1e-2, vf=0.0, gan=0.0)

    def loss_fn(p):
        recon, mu, logvar = jm.apply({"params": p}, batch, sample=False)
        return jax_transvae_loss(recon, batch, mu, logvar, jw)["total"]

    loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = jax_to_sd(jax.tree_util.tree_map(np.asarray, jgrads), None)
    weights = LossWeights(l1=1.0, lpips=0.0, kl=1e-2, vf=0.0, gan=0.0)
    grads, metrics = compute_grads(port, torch.from_numpy(batch), weights, sample=False)
    _close(float(metrics["total"]), float(loss), rtol=1e-5)
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for name, g in zip(names, grads):
        _close(g.numpy(), want[name], rtol=0, atol=1e-4 * top)


def test_grad_accumulation_equals_full_batch(micro_pair):
    port = micro_pair[0]
    batch = torch.from_numpy(np.random.default_rng(5).random((4, 32, 32, 3), dtype=np.float32))
    weights = LossWeights(l1=1.0, lpips=0.0, kl=1e-2, vf=0.0, gan=0.0)
    full, mf = compute_grads(port, batch, weights, sample=False)
    acc, ma = compute_grads(port, batch, weights, accum_steps=2, sample=False)
    _close(float(ma["total"]), float(mf["total"]), rtol=1e-5)
    top = max(float(f.abs().max()) for f in full)
    for a, f in zip(acc, full):
        _close(a.numpy(), f.numpy(), rtol=0, atol=1e-5 * top)
    with pytest.raises(ValueError):
        compute_grads(port, batch[:3], weights, accum_steps=2)


def test_reparameterize_with_given_noise(micro_pair):
    port = micro_pair[0]
    rng = np.random.default_rng(6)
    mu = torch.from_numpy(rng.standard_normal((2, 4, 2, 2)).astype(np.float32))
    logvar = torch.from_numpy((30 * rng.standard_normal((2, 4, 2, 2))).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 4, 2, 2)).astype(np.float32))
    z = port.reparameterize(mu, logvar, eps=eps)
    want = mu.numpy() + eps.numpy() * np.exp(0.5 * np.clip(logvar.numpy(), -30.0, 20.0))
    _close(z.numpy(), want, rtol=1e-6)
    zb = port.reparameterize(mu.bfloat16(), logvar.bfloat16(), eps=eps)
    assert zb.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(3)
    a = port.reparameterize(mu, logvar, generator=g)
    assert not torch.equal(a, port.reparameterize(mu, logvar, generator=g))


# -- trainer, checkpoints, CLI, interop -------------------------------------------
def _trainer(out, epochs=1, **kw):
    tc = TrainerConfig(batch_size=4, accum_steps=2, warmup_steps=2, num_epochs=epochs,
                       steps_per_epoch=3, log_every=1, resolution=32, output_dir=str(out),
                       weights=LossWeights(gan=0.0), save_every_epochs=1, seed=1, **kw)
    return Trainer(get_config(VARIANT, **MICRO), tc, device="cpu")


def _data():
    return batch_iterator(make_dataset("shapes", resolution=32, num_samples=400), 4)


def test_trainer_fit_checkpoint_and_resume(tmp_path):
    trainer = _trainer(tmp_path, eval_every_steps=3)
    state = trainer.create_state()
    before = state.model.decoder.conv_out.weight.detach().clone()
    val = list(batch_iterator(make_dataset("shapes", resolution=32, num_samples=4, seed=9), 4))
    state = trainer.fit(_data(), state=state, val_batches=val)
    assert state.step == 3
    rows = [json.loads(line) for line in open(tmp_path / "history.jsonl")]
    losses = [r["total"] for r in rows if r["kind"] == "train"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert any(r["kind"] == "val" and np.isfinite(r["val_psnr"]) for r in rows)
    assert not torch.equal(before, state.model.decoder.conv_out.weight)
    ckpt = tmp_path / "checkpoints"
    assert latest_step(str(ckpt)) == 3 and latest_step(str(tmp_path / "checkpoints_best")) == 3
    assert load_config(str(ckpt)).attention_impl == "auto"  # the inference dispatch
    saved, meta = restore_checkpoint(str(ckpt))
    assert saved["step"] == 3 and saved["optimizer"]["count"] == 3 and meta["epoch"] == 0
    # Resume: the second run continues from step 3 with the saved moments.
    resumed = _trainer(tmp_path, epochs=2).fit(_data())
    assert resumed.step == 9
    assert sorted(int(f[5:14]) for f in os.listdir(ckpt) if f.endswith(".pt")) == [3, 6, 9]


def test_checkpoint_interop_and_synthetic_data(tmp_path, micro_pair):
    # A port checkpoint's model state_dict taken back by the JAX package's
    # torch_state_dict_to_params gives the params it started from.
    port, _, params = micro_pair
    trainer = _trainer(tmp_path)
    state = trainer.create_state()
    load_jax_params(state.model, params)
    trainer.save(state, epoch=0)
    saved, _ = restore_checkpoint(str(tmp_path / "checkpoints"))
    back = torch_state_dict_to_params({k: v.numpy() for k, v in saved["model"].items()},
                                      jax_get_config(VARIANT, **MICRO))
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))
    # Synthetic batches are byte-equal to the JAX package's for a seed.
    for ours, theirs in ((make_dataset("synthetic", 16, num_samples=3, seed=5),
                          jax_synthetic(16, 3, 5)),
                         (make_dataset("shapes", 16, num_samples=3, seed=5), jax_shapes(16, 3, 5))):
        for a, b in zip(ours, theirs, strict=True):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# A model axis needs its ranks, which only a launcher (torchrun) starts: a
# single process refuses it and says so, with the scan layout as without it
# (--scan_blocks trains under every --param_sharding:
# tests/test_torch_scan_parallel.py runs it under tensor parallelism).
@pytest.mark.parametrize("flags", [["--scan_blocks", "--param_sharding", "fsdp",
                                    "--mesh_model", "2"],
                                   ["--mesh_model", "2"],
                                   ["--param_sharding", "fsdp", "--mesh_model", "2"]])
def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, flags):
    with pytest.raises(SystemExit, match="launch under torchrun"):
        train_cli.main(["--output_dir", str(tmp_path), "--device", "cpu", *flags])


def test_trainer_refuses_what_is_not_ported(tmp_path):
    cfg = get_config(VARIANT, **MICRO)
    with pytest.raises(ValueError, match="launch under torchrun"):
        Trainer(cfg, TrainerConfig(weights=LossWeights(gan=0.0), mesh_model=2), device="cpu")


@pytest.mark.parametrize("flag", ["--gradient_checkpointing", "--optimizer adafactor",
                                  "--vf_weight 0.1", "--perceptual self"])
def test_train_cli_runs_the_stage1_flags(tmp_path, monkeypatch, capsys, flag):
    """Each flag the port took over in its stage-1 slice, for one step of the
    CLI on the CPU (the CLI's model is the micro model: its variant
    resolution is patched, as in tests/test_torch_gan.py)."""
    monkeypatch.setattr(train_cli, "get_config",
                        lambda *a, **kw: get_config(VARIANT, **{**kw, **MICRO}))
    extra = flag.split()
    if flag == "--perceptual self":  # a trained checkpoint: the micro model's
        src = _trainer(tmp_path / "src")
        src.save(src.create_state(), epoch=0)
        extra += ["--perceptual_checkpoint", str(tmp_path / "src" / "checkpoints")]
    out = tmp_path / "run"
    train_cli.main(["--data", "shapes", "--resolution", "32", "--batch_size", "2",
                    "--num_epochs", "1", "--steps_per_epoch", "1", "--log_every", "1",
                    "--warmup_steps", "1", "--device", "cpu", "--output_dir", str(out),
                    *extra])
    (row,) = [json.loads(line) for line in open(out / "history.jsonl")]
    assert row["step"] == 1 and np.isfinite(row["total"])
    saved, _ = restore_checkpoint(str(out / "checkpoints"))
    log = capsys.readouterr().out
    if flag == "--gradient_checkpointing":
        cfg = load_config(str(out / "checkpoints"))
        assert cfg.remat and cfg.remat_policy == train_cli.CLI_REMAT_POLICY == "none"
    elif flag == "--optimizer adafactor":
        assert saved["optimizer"]["kind"] == "adafactor"
    elif flag == "--vf_weight 0.1":
        assert row["vf"] > 0 and "vf_proj" in saved and "stub teacher" in log
    else:
        assert row["lpips"] > 0 and "perceptual=self" in log


def test_input_pipeline_batches_and_errors():
    from deepl_project_tpu_torch.data import input_pipeline

    batches = list(input_pipeline(make_dataset("synthetic", 8, num_samples=7, seed=2), 3, "cpu"))
    want = list(batch_iterator(make_dataset("synthetic", 8, num_samples=7, seed=2), 3))
    assert len(batches) == len(want) == 2
    for b, w in zip(batches, want):
        assert isinstance(b, torch.Tensor) and np.array_equal(b.numpy(), w)

    def broken():
        yield np.zeros((8, 8, 3), np.float32)
        raise OSError("corrupt file")

    with pytest.raises(OSError, match="corrupt"):
        list(input_pipeline(broken(), 1, "cpu"))
    with pytest.raises(FileNotFoundError, match="No images"):
        list(make_dataset("/data/imagenet"))


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    """Force one decoder in both packages (tests/test_torch_data.py's
    fixture): the two decoders differ by a step of 1/255, so a byte-equal
    comparison needs the same one on both sides. A worker that lost the
    JAX package's unlocked native build at collection has its loader's
    ``_tried`` reset, so it loads the library the winner built."""
    import deepl_project_tpu.data.native_loader as jnative
    import deepl_project_tpu_torch.data.native_loader as pnative

    if request.param == "pil":
        monkeypatch.setattr(jnative, "native_available", lambda: False)
        monkeypatch.setattr(pnative, "native_available", lambda: False)
    else:
        if jnative._lib is None:
            monkeypatch.setattr(jnative, "_tried", False)
        assert jnative.native_available(), "the JAX package's native decoder did not load"
        assert pnative.native_available(), pnative.build_error()
    return request.param


def test_train_cli_on_an_image_folder(tmp_path, monkeypatch, decoder):
    """cli.train --data <folder>: the first training batch is the first batch
    of the source the JAX CLI builds for the same flags (repeat, min(cpu, 16)
    decode threads, seed 42), and the validation batches are that same
    source's first batches, as in the JAX CLI; with each decoder forced in
    both packages (``decoder``)."""
    from PIL import Image

    from deepl_project_tpu.data import make_dataset as jax_make_dataset
    from deepl_project_tpu.data.pipeline import batch_iterator as jax_batch_iterator

    rng = np.random.RandomState(0)
    for i in range(6):
        os.makedirs(tmp_path / "images" / f"c{i % 2}", exist_ok=True)
        arr = (rng.rand(40 + 4 * i, 36, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / "images" / f"c{i % 2}" / f"{i}.png")
    folder = str(tmp_path / "images")
    monkeypatch.setattr(train_cli, "get_config",
                        lambda *a, **kw: get_config(VARIANT, **{**kw, **MICRO}))
    seen = {}
    pipeline = train_cli.input_pipeline

    def first_batch(source, batch_size, device, **kw):
        for b in pipeline(source, batch_size, device, **kw):
            seen.setdefault("train", b.numpy().copy())
            yield b

    class Recording(Trainer):
        def fit(self, data_iter, state=None, val_batches=None):
            seen["val"] = val_batches
            return super().fit(data_iter, state, val_batches)

    monkeypatch.setattr(train_cli, "input_pipeline", first_batch)
    monkeypatch.setattr(train_cli, "Trainer", Recording)
    out = tmp_path / "run"
    train_cli.main(["--data", folder, "--resolution", "32", "--batch_size", "2",
                    "--num_epochs", "1", "--steps_per_epoch", "1", "--log_every", "1",
                    "--warmup_steps", "1", "--eval_every_steps", "1", "--val_batches", "2",
                    "--lpips_weight", "0", "--device", "cpu", "--output_dir", str(out)])
    workers = min(os.cpu_count() or 1, 16)
    jax_source = jax_make_dataset(folder, resolution=32, repeat=True, num_workers=workers)
    want = next(jax_batch_iterator(jax_source, 2))
    assert seen["train"].tobytes() == want.tobytes()
    jax_val = list(zip(range(2), jax_batch_iterator(jax_make_dataset(folder, resolution=32), 2)))
    assert len(seen["val"]) == 2 and seen["val"][0].tobytes() == want.tobytes()
    assert all(a.tobytes() == b.tobytes() for a, (_, b) in zip(seen["val"], jax_val))
    rows = [json.loads(line) for line in open(out / "history.jsonl")]
    assert [r["kind"] for r in rows] == ["train", "val"] and np.isfinite(rows[0]["total"])
