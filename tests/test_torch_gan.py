"""Stage 2 of the port against the JAX package's, on the CPU: the PatchGAN
discriminator and its instance norm, the adaptive GAN weight, the rule by
which a trainer resumes a stage hand-off, the stage-2 checkpoint and the
train CLI's --use_gan. The GAN step itself is held to the JAX step in
tests/test_torch_gan_step.py.

- The discriminator at 32 and 64 px with 2 and 3 layers, fp32 and bf16, on
  JAX-layout weights drawn from a numpy seed and carried across with
  ``utils.convert.load_jax_disc_params``; the instance norm alone.
- ``maybe_resume``: the JAX ``Trainer`` and the port's restore the same
  things (step, optimizer count and moments, EMA source, the
  discriminator's step and count) in every hand-off case. The JAX
  checkpoints hold states as after two updates, made without a model step
  (a JAX model step costs ~15 s to compile); the port's come from two steps
  of ``Trainer.fit``.

Tolerances: discriminator and instance norm in fp32 1e-5 x the largest
|output| (sums in another order); in bf16 2^-5 x the largest |output|
(eight bf16 steps: the convs' fp32 sums in another order round to other
bf16 values, and five layers carry the differences on);
the adaptive weight 1e-6 relative.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.models.discriminator import InstanceNorm as JaxInstanceNorm
from deepl_project_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from deepl_project_tpu.models.transvae import adaptive_gan_weight as jax_adaptive_gan_weight
from deepl_project_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from deepl_project_tpu.training.train_step import init_ema_train_state, init_train_state
from deepl_project_tpu.training.trainer import Trainer as JaxTrainer
from deepl_project_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.cli import train as train_cli
from deepl_project_tpu_torch.data import batch_iterator, make_dataset
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.models import (InstanceNorm, PatchDiscriminator, TransVAE,
                                            adaptive_gan_weight, get_last_layer,
                                            init_disc_weights, init_weights)
from deepl_project_tpu_torch.training import (Trainer, TrainerConfig, latest_step,
                                              restore_checkpoint, save_checkpoint)
from deepl_project_tpu_torch.utils.convert import (disc_params_to_torch_state_dict,
                                                   load_jax_disc_params)

torch.set_num_threads(2)
# The micro model of tests/test_torch_training.py.
MICRO = dict(depths=(1, 1, 1, 1), base_dims=(16, 16, 32, 64), latent_dim=4,
             head_dim=16, dtype="float32", attention_impl="auto_train", use_dc_path=False)
VARIANT = "tiny_f8d16"
RES = 32


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def jax_disc_params(disc, res: int, seed: int) -> dict:
    """JAX-layout params for ``disc`` from a numpy seed: N(0, 0.02) kernels
    and, so that every leaf shows, nonzero biases and norm affines."""
    shapes = jax.eval_shape(disc.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, res, res, 3)))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        base, std = {"kernel": (0.0, 0.02), "scale": (1.0, 0.1)}.get(leaf, (0.0, 0.1))
        return (base + std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# -- the discriminator ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res,layers", [(32, 2), (32, 3), (64, 2), (64, 3)])
def test_patch_discriminator_matches_jax(res, layers, dtype):
    jd = JaxPatchDiscriminator(num_layers=layers, dtype=getattr(jnp, dtype))
    params = jax_disc_params(jd, res, seed=res + layers)
    x = np.random.default_rng(layers).random((2, res, res, 3), dtype=np.float32)
    want = np.asarray(jd.apply({"params": params}, x))
    port = PatchDiscriminator(num_layers=layers, dtype=getattr(torch, dtype), device="cpu")
    load_jax_disc_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    side = res // 2 ** layers - 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, side, side)
    tol = 1e-5 if dtype == "float32" else 2 ** -5
    _close(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
           atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((3 * rng.standard_normal((2, 5, 6, 8)) + 1).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    scale = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    jx = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    want = JaxInstanceNorm(8, dtype=getattr(jnp, dtype)).apply(
        {"params": {"scale": scale, "bias": bias}}, jx)
    port = InstanceNorm(8, dtype=getattr(torch, dtype))
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = port(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2 ** -5
    _close(got.float().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def test_discriminator_shapes_init_and_min_input():
    port = PatchDiscriminator(num_layers=3, dtype=torch.float32, device="cpu")
    init_disc_weights(port, torch.Generator().manual_seed(5))
    convs = [m for m in port.modules() if isinstance(m, torch.nn.Conv2d)]
    assert [c.bias is not None for c in convs] == [True, False, False, False, True]
    assert [c.out_channels for c in convs] == [64, 128, 256, 512, 1]
    w = torch.cat([c.weight.detach().flatten() for c in convs])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert all(float(c.bias.detach().abs().max()) == 0 for c in convs if c.bias is not None)
    # The converter's names are the port's: a JAX tree loads strictly.
    params = jax_disc_params(JaxPatchDiscriminator(), 24, seed=0)
    assert set(disc_params_to_torch_state_dict(params)) == set(port.state_dict())
    # 256px gives a 30 x 30 logit map on both sides; below 3 * 2^L px both raise.
    jd = JaxPatchDiscriminator(num_layers=3)
    out = jax.eval_shape(lambda x: jd.init_with_output(jax.random.PRNGKey(0), x)[0],
                         jnp.zeros((1, 256, 256, 3)))
    assert out.shape == (1, 30, 30, 1)
    with torch.no_grad():
        assert tuple(port(torch.rand(1, 3, 256, 256)).shape) == (1, 1, 30, 30)
        assert tuple(port(torch.rand(1, 3, 24, 24)).shape) == (1, 1, 1, 1)
        with pytest.raises(ValueError, match="needs inputs >= 24px"):
            port(torch.zeros(1, 3, 23, 40))
    with pytest.raises(ValueError, match="needs inputs >= 24px"):
        jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, 23, 40, 3)))


def test_adaptive_gan_weight_matches_jax_and_clamps():
    rng = np.random.default_rng(7)
    for scale in (1.0, 1e-3, 1e-6):
        rec = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
        gan = (scale * rng.standard_normal((4, 3, 3, 3))).astype(np.float32)
        for cap in (1e4, 1.0):
            _close(float(adaptive_gan_weight(torch.from_numpy(rec), torch.from_numpy(gan), cap)),
                   float(jax_adaptive_gan_weight(rec, gan, cap)), rtol=1e-6)
    # As tests/test_training.py::test_adaptive_gan_weight_clamp: a near-zero
    # GAN gradient must not amplify the term beyond the clamp.
    rec, gan = torch.ones(8, requires_grad=True), torch.ones(8) * 1e-3
    assert float(adaptive_gan_weight(rec, gan)) > 100
    clamped = adaptive_gan_weight(rec, gan, max_weight=1.0)
    assert float(clamped) == 1.0 and not clamped.requires_grad
    model = TransVAE(get_config(VARIANT, **MICRO), device="cpu")
    assert get_last_layer(model) is model.decoder.conv_out.weight


# -- the stage hand-off resume rule --------------------------------------------------
# (gan, freeze_encoder, ema_decay) of a trainer.
STAGE1 = (False, False, 0.0)
STAGE2 = (True, True, 0.999)  # README.md's stage-2 recipe
CASES = {
    # id: (saving trainer, drop disc_step, resuming trainer, what both restore)
    "freeze_toggled": (STAGE1, False, (False, True, 0.0),
                       dict(step=2, count=0, moments_zero=True, ema=None, disc=None)),
    "same_stage": (STAGE1, False, STAGE1,
                   dict(step=2, count=2, moments_zero=False, ema=None, disc=None)),
    "ema_added": (STAGE1, False, (False, False, 0.999),
                  dict(step=2, count=0, moments_zero=True, ema="params", disc=None)),
    # The discriminator's keys are expected only when the checkpoint has
    # them, so a stage-1 checkpoint resumes fully into a GAN trainer that
    # trains the same parameters; D starts fresh.
    "stage1_into_gan": (STAGE1, False, (True, False, 0.0),
                        dict(step=2, count=2, moments_zero=False, ema=None, disc=(0, 0))),
    "stage1_into_gan_recipe": (STAGE1, False, STAGE2,
                               dict(step=2, count=0, moments_zero=True, ema="params",
                                    disc=(0, 0))),
    "stage2_into_gan": (STAGE2, False, STAGE2,
                        dict(step=2, count=2, moments_zero=False, ema="saved", disc=(2, 2))),
    "stage2_without_disc_step": (STAGE2, True, STAGE2,
                                 dict(step=2, count=2, moments_zero=False, ema="saved",
                                      disc=(0, 2))),
    "stage2_into_stage1": (STAGE2, False, (False, True, 0.999),
                           dict(step=2, count=0, moments_zero=True, ema="params", disc=None)),
}


@pytest.fixture(scope="module")
def shared_params():
    """The micro model's weights (drawn by the port, as a JAX tree) and a
    JAX-layout discriminator tree."""
    cfg = get_config(VARIANT, **MICRO)
    src = TransVAE(cfg, device="cpu")
    init_weights(src, torch.Generator().manual_seed(0))
    params = torch_state_dict_to_params({k: v.numpy() for k, v in src.state_dict().items()},
                                        jax_get_config(VARIANT, **MICRO))
    return params, jax_disc_params(JaxPatchDiscriminator(), RES, seed=1)


def _jax_trainer(out, kind):
    gan, freeze, ema = kind
    w = JaxLossWeights(l1=1.0, lpips=0.0, kl=0.0, vf=0.0, gan=0.5 if gan else 0.0)
    tc = JaxTrainerConfig(batch_size=2, resolution=RES, use_lpips=False, num_epochs=1,
                          steps_per_epoch=2, warmup_steps=2, save_every_epochs=1,
                          log_every=100, weights=w, output_dir=str(out),
                          freeze_encoder=freeze, ema_decay=ema)
    return JaxTrainer(jax_get_config(VARIANT, **MICRO), tc)


def _names(path):
    return [getattr(p, "name", getattr(p, "key", None)) for p in path]


def _as_if_updated(opt_state, count: int):
    """An optax state as after ``count`` updates: counts set, moments 0.5."""
    def f(path, x):
        names = _names(path)
        if names[-1] == "count":
            return jnp.full_like(x, count)
        return jnp.full_like(x, 0.5) if {"mu", "nu"} & set(names) else x
    return jax.tree_util.tree_map_with_path(f, opt_state)


def _jax_states(tr, params, dparams, kind, updated: bool):
    """The generator's and (with the GAN) the discriminator's train states:
    as after two updates, or fresh (zero params, so a restore shows)."""
    gan, _, ema = kind
    tree = {"model": jax.tree_util.tree_map(jnp.asarray if updated else jnp.zeros_like, params)}
    state = (init_ema_train_state if ema else init_train_state)(tree, tr.tx)
    if updated:
        state = state.replace(step=jnp.asarray(2, jnp.int32),
                              opt_state=_as_if_updated(state.opt_state, 2))
        if ema:
            state = state.replace(ema_params=jax.tree_util.tree_map(
                lambda p: p + 0.25, state.params))
    if gan:
        d = init_train_state({"model": jax.tree_util.tree_map(jnp.asarray, dparams)},
                             tr.disc_tx)
        if updated:
            d = d.replace(step=jnp.asarray(2, jnp.int32),
                          opt_state=_as_if_updated(d.opt_state, 2))
        tr._disc_state = d
    return state


def _jax_save(out, kind, params, dparams, drop_disc_step: bool):
    tr = _jax_trainer(out, kind)
    state = _jax_states(tr, params, dparams, kind, updated=True)
    if not drop_disc_step:
        tr.save(state, epoch=0)
        return
    d = tr._disc_state
    payload = {"params": state.params, "opt_state": state.opt_state, "step": state.step,
               "ema_params": state.ema_params, "disc_params": d.params,
               "disc_opt_state": d.opt_state}
    jax_save_checkpoint(os.path.join(str(out), "checkpoints"), 2, payload, epoch=0,
                        config=tr.model_config)


def _jax_restored(out, kind, params, dparams, saved_ema) -> dict:
    tr = _jax_trainer(out, kind)
    state, _ = tr.maybe_resume(_jax_states(tr, params, dparams, kind, updated=False))
    leaves = jax.tree_util.tree_flatten_with_path(state.opt_state)[0]
    count = max(int(v) for p, v in leaves if _names(p)[-1] == "count")
    moments = [np.asarray(v) for p, v in leaves if {"mu", "nu"} & set(_names(p))]

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                                       jax.tree_util.tree_leaves(b)))

    ema = None
    if getattr(state, "ema_params", None) is not None:
        ema = ("saved" if same(state.ema_params["model"], saved_ema)
               else "params" if same(state.ema_params, state.params) else "other")
    disc = None
    if kind[0]:
        d = tr._disc_state
        dl = jax.tree_util.tree_flatten_with_path(d.opt_state)[0]
        disc = (int(d.step), max(int(v) for p, v in dl if _names(p)[-1] == "count"))
    return dict(step=int(state.step), count=count,
                moments_zero=all(not m.any() for m in moments), ema=ema, disc=disc)


def _port_trainer(out, kind):
    gan, freeze, ema = kind
    tc = TrainerConfig(batch_size=2, warmup_steps=2, num_epochs=1, steps_per_epoch=2,
                       log_every=100, resolution=RES, output_dir=str(out), seed=1,
                       weights=LossWeights(lpips=0.0, vf=0.0, gan=0.5 if gan else 0.0),
                       save_every_epochs=1, freeze_encoder=freeze, ema_decay=ema)
    return Trainer(get_config(VARIANT, **MICRO), tc, device="cpu")


def _data(seed=0):
    return batch_iterator(make_dataset("shapes", resolution=RES, num_samples=64, seed=seed), 2)


def _port_save(out, kind, drop_disc_step: bool):
    _port_trainer(out, kind).fit(_data())
    if drop_disc_step:
        ckpt = os.path.join(str(out), "checkpoints")
        payload, meta = restore_checkpoint(ckpt)
        del payload["disc_step"]
        save_checkpoint(ckpt, meta["step"], payload, epoch=meta["epoch"])


def _port_restored(out, kind) -> dict:
    tr = _port_trainer(out, kind)
    state, _ = tr.maybe_resume(tr.create_state())
    saved, _ = restore_checkpoint(os.path.join(str(out), "checkpoints"))
    opt = state.optimizer
    moments = [m for m in opt.mu + opt.nu if m is not None]
    ema = None
    if state.ema is not None:
        params = dict(state.model.named_parameters())
        ema = ("saved" if "ema" in saved and all(torch.equal(t, saved["ema"][n])
                                                 for n, t in state.ema.items())
               else "params" if all(torch.equal(t, params[n]) for n, t in state.ema.items())
               else "other")
    disc = None
    if tr.use_gan:
        d = tr._disc_state
        disc = (0, 0) if d is None else (d.step, d.optimizer.count)
    return dict(step=state.step, count=opt.count,
                moments_zero=all(not bool(m.any()) for m in moments), ema=ema, disc=disc)


@pytest.fixture(scope="module")
def saved_runs(tmp_path_factory, shared_params):
    """One JAX and one port checkpoint directory for each saving trainer."""
    params, dparams = shared_params
    runs = {}
    for kind, drop in {(c[0], c[1]) for c in CASES.values()}:
        root = tmp_path_factory.mktemp("saved")
        _jax_save(root / "jax", kind, params, dparams, drop)
        _port_save(root / "port", kind, drop)
        runs[kind, drop] = root
    return runs


@pytest.mark.parametrize("case", list(CASES))
def test_resume_rule_matches_jax(case, saved_runs, shared_params, tmp_path, capsys):
    saving, drop, resuming, expected = CASES[case]
    params, dparams = shared_params
    for side in ("jax", "port"):
        shutil.copytree(saved_runs[saving, drop] / side, tmp_path / side)
    saved_ema = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.25, params)
    want = _jax_restored(tmp_path / "jax", resuming, params, dparams, saved_ema)
    jax_log = capsys.readouterr().out
    got = _port_restored(tmp_path / "port", resuming)
    port_log = capsys.readouterr().out
    assert want == expected, (case, want)
    assert got == want, (case, got, want)
    # The hand-off prints the JAX trainer's warning.
    for log in (jax_log, port_log):
        assert ("restoring params/step only (optimizer state reset)" in log) == (
            expected["count"] == 0), log


def test_stage2_save_and_resume_keeps_disc_step(tmp_path):
    """As tests/test_training.py's stage-2 round trip and disc-step tests:
    stage 1 (2 steps), stage 2 from its checkpoint (generator 2 -> 4, D 0 ->
    2), then a resumed stage 2 restores D's own step, parameters and
    optimizer and takes another step."""
    _port_trainer(tmp_path, STAGE1).fit(_data())
    tr2 = _port_trainer(tmp_path, STAGE2)
    state = tr2.fit(_data(1))
    assert state.step == 4 and tr2._disc_state.step == 2
    saved, _ = restore_checkpoint(str(tmp_path / "checkpoints"))
    assert saved["disc_step"] == 2 and saved["disc_optimizer"]["count"] == 2
    assert set(saved) == {"model", "optimizer", "step", "ema", "disc_model",
                          "disc_optimizer", "disc_step"}
    # The frozen encoder has no moments and did not move in stage 2.
    assert not any(n.startswith("encoder.") for n in saved["optimizer"]["mu"])
    tr3 = _port_trainer(tmp_path, STAGE2)
    state, _ = tr3.maybe_resume(tr3.create_state())
    d = tr3._disc_state
    assert state.step == 4 and d.step == 2 and d.optimizer.count == 2
    for n, t in d.model.state_dict().items():
        assert torch.equal(t, saved["disc_model"][n])
    batch = torch.from_numpy(next(_data(2)))
    metrics = tr3.step_fn(state, batch)
    assert state.step == 5 and d.step == 3
    assert np.isfinite(float(metrics["disc_loss"])) and np.isfinite(float(metrics["total"]))


# -- the train CLI ---------------------------------------------------------------
@pytest.mark.parametrize("gan_weight", [None, "0.05"])
def test_train_cli_use_gan(tmp_path, monkeypatch, gan_weight):
    """--use_gan trains stage 2 with the GAN term at --gan_weight; without
    --gan_weight the weight is 0 and the run is stage 1, as in the JAX CLI.
    The CLI's model is the micro model (its variant resolution is patched)."""
    monkeypatch.setattr(train_cli, "get_config",
                        lambda *a, **kw: get_config(VARIANT, **{**kw, **MICRO}))
    flags = ["--data", "shapes", "--resolution", str(RES), "--batch_size", "2",
             "--num_epochs", "1", "--steps_per_epoch", "2", "--log_every", "1",
             "--lpips_weight", "0", "--use_gan", "--freeze_encoder", "--ema_decay", "0.999",
             "--gan_r1_gamma", "10", "--device", "cpu", "--output_dir", str(tmp_path)]
    train_cli.main(flags + (["--gan_weight", gan_weight] if gan_weight else []))
    rows = [json.loads(line) for line in open(tmp_path / "history.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    saved, _ = restore_checkpoint(str(tmp_path / "checkpoints"))
    if gan_weight:
        for key in ("disc_loss", "disc_r1", "disc_real_mean", "disc_fake_mean",
                    "disc_update_scale", "gan_scale", "grad_norm"):
            assert all(np.isfinite(r[key]) for r in rows), key
        assert rows[0]["gan"] > 0 and saved["disc_step"] == 2
    else:
        assert "disc_loss" not in rows[0] and rows[0]["gan"] == 0
        assert "disc_model" not in saved
    assert latest_step(str(tmp_path / "checkpoints")) == 2
