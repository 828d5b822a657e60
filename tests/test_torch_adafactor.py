"""The port's Adafactor against the JAX package's optax chain (``make_optimizer(
optimizer='adafactor')``: apply_if_finite(multi_transform(chain(
clip_by_global_norm, adafactor(min_dim_size_to_factor=128, decay_rate=0.8,
momentum=None, multiply_by_parameter_scale=False))))), step for step.

The parameters are in the port's layout, each beside its JAX leaf: convs
[O, I, kh, kw] against [kh, kw, I, O], linears [O, I] against [I, O]. optax
factors the second moment over the two largest axes of the JAX leaf, so the
port must pick the same two in its own layout: a factored conv and linear,
a conv and a linear with tied sizes (the tie broken as ``np.argsort`` breaks
it), a kernel that keeps its layout (``vf_proj.kernel``), an unfactored
weight (second-largest axis < 128) and a bias. Five steps: two above the
clip norm, one non-finite (skipped), warmup 3; the encoder frozen and not.

Also the whole slice: two ``Trainer.fit`` steps of a micro model with VF
0.1, remat 'dots' and Adafactor in both packages from the same weights
(losses per step and parameters after), and the checkpoint of such a run
(vf_proj, the Adafactor state and the EMA of both survive a resume; AdamW
after Adafactor starts a fresh optimizer).

Tolerance: rtol 1e-6 / atol 1e-7, as ``test_optimizer_matches_optax``; the
whole slice's at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepl_project_tpu.training.optim import make_optimizer as jax_make_optimizer
from deepl_project_tpu_torch.training import make_optimizer
from deepl_project_tpu_torch.training.optim import Adafactor, factored_dims, jax_layout

# (port name, port shape); the JAX leaf is model/<name> with the port shape
# permuted by jax_layout (vf_proj: params['vf_proj']).
PARAMS = [
    ("encoder.conv.weight", (160, 130, 3, 3)),   # factored (O, I) in both
    ("encoder.norm.weight", (130,)),
    ("decoder.conv.weight", (128, 128, 3, 3)),   # tied sizes
    ("decoder.lin.weight", (200, 130)),          # factored linear
    ("decoder.lin.bias", (200,)),
    ("decoder.tied.weight", (128, 128)),         # tied linear
    ("decoder.small.weight", (64, 300)),         # unfactored: 64 < 128
    ("decoder.pw.weight", (256, 128, 1, 1)),     # 1x1 conv
    ("vf_proj.kernel", (130, 300)),              # the JAX layout already
]


def _tree(arrays: dict) -> dict:
    """The JAX tree of port-layout arrays."""
    tree: dict = {"model": {}}
    for name, a in arrays.items():
        perm = jax_layout(name, a.shape)
        leaf = np.ascontiguousarray(np.transpose(a, perm))
        if name.startswith("vf_proj."):
            tree.setdefault("vf_proj", {})[name.split(".")[1]] = leaf
            continue
        top, mod, key = name.split(".")
        tree["model"].setdefault(top, {}).setdefault(mod, {})[key] = leaf
    return tree


def _port_view(tree: dict) -> dict:
    """Port-layout numpy arrays from the JAX tree."""
    out = {}
    for name, shape in PARAMS:
        if name.startswith("vf_proj."):
            leaf = tree["vf_proj"][name.split(".")[1]]
        else:
            top, mod, key = name.split(".")
            leaf = tree["model"][top][mod][key]
        out[name] = np.transpose(np.asarray(leaf), np.argsort(jax_layout(name, shape)))
    return out


def test_factored_dims_follow_the_jax_layout():
    # port axes (row, col): v_row is the mean over col, v_col over row.
    assert factored_dims("encoder.conv.weight", (160, 130, 3, 3)) == (1, 0)
    assert factored_dims("decoder.lin.weight", (200, 130)) == (1, 0)
    assert factored_dims("vf_proj.kernel", (130, 300)) == (0, 1)
    assert factored_dims("decoder.small.weight", (64, 300)) is None
    assert factored_dims("decoder.lin.bias", (200,)) is None
    # Tied sizes: JAX [kh, kw, I, O] -> argsort picks (I, O) = port (1, 0).
    assert factored_dims("decoder.conv.weight", (128, 128, 3, 3)) == (1, 0)
    assert factored_dims("decoder.tied.weight", (128, 128)) == (1, 0)


@pytest.mark.parametrize("freeze", [False, True])
def test_adafactor_matches_optax(freeze):
    rng = np.random.default_rng(0)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in PARAMS}
    scales = [5.0, 0.1, 1.0, 3.0, 0.2]
    grads = [{n: (sc * rng.standard_normal(s)).astype(np.float32) for n, s in PARAMS}
             for sc in scales]
    grads[2]["decoder.lin.bias"][3] = np.inf
    kw = dict(learning_rate=0.05, warmup_steps=3, max_grad_norm=1.0,
              freeze_encoder=freeze, optimizer="adafactor")
    tx = jax_make_optimizer(**kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(params))
    state = tx.init(jparams)
    tensors = [(n, torch.from_numpy(params[n].copy())) for n, _ in PARAMS]
    opt = make_optimizer(tensors, **kw)
    assert isinstance(opt, Adafactor)
    for i, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(g)), state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step([torch.from_numpy(g[n].copy()) for n, _ in PARAMS])
        assert applied == (i != 2)
        want = _port_view(jparams)
        for name, t in tensors:
            np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} {name}")
    assert opt.count == 4 and opt.total_notfinite == 1 and opt.notfinite_count == 0
    frozen = {"encoder.conv.weight", "encoder.norm.weight"} if freeze else set()
    for name, t in tensors:
        assert np.array_equal(t.numpy(), params[name]) == (name in frozen), name
    saved = opt.state_dict()
    assert saved["kind"] == "adafactor"
    assert set(saved["v"]) | set(saved["v_row"]) == {n for n, _ in PARAMS} - frozen
    assert set(saved["v_row"]) == set(saved["v_col"]) == {
        "decoder.conv.weight", "decoder.lin.weight", "decoder.tied.weight",
        "decoder.pw.weight", "vf_proj.kernel"} | ({"encoder.conv.weight"} - frozen)
    # The factored state is row and column means: < 5% of the parameters.
    factored = sum(t.numel() for n, t in tensors if n in saved["v_row"])
    assert sum(t.numel() for k in ("v_row", "v_col") for t in saved[k].values()) < 0.05 * factored


def test_adafactor_refuses_weight_decay_as_jax_does():
    with pytest.raises(ValueError, match="weight_decay with optimizer='adafactor'"):
        jax_make_optimizer(optimizer="adafactor", weight_decay=0.1)
    with pytest.raises(ValueError, match="weight_decay with optimizer='adafactor'"):
        make_optimizer([("w", torch.zeros(2))], optimizer="adafactor", weight_decay=0.1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer([("w", torch.zeros(2))], optimizer="sgd")


# -- the whole slice: Trainer.fit with VF, remat and Adafactor ------------------------
VARIANT = "tiny_f8d16"
MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
             dtype="float32", attention_impl="auto_train", use_dc_path=False,
             logvar_clip=(-80.0, 20.0))
TEACHER = dict(feature_dim=8, patch=4, resize=16, seed=3)


def _jax_stub_proj(feature_dim, patch, seed):
    """JAX make_stub_teacher's projection (its body's draw)."""
    fan = patch * patch * 3
    proj = jax.random.normal(jax.random.PRNGKey(seed), (fan, feature_dim), jnp.float32)
    return np.asarray(proj / jnp.sqrt(fan))


def _trainer_kw(out, **kw):
    return dict(batch_size=2, warmup_steps=0, learning_rate=1e-3, num_epochs=1,
                steps_per_epoch=2, log_every=1, resolution=32, output_dir=str(out),
                use_lpips=False, optimizer="adafactor", seed=1, **kw)


def test_whole_slice_fit_matches_jax(tmp_path):
    """Two Trainer.fit steps of a micro model with VF 0.1 (the stub teacher),
    remat 'dots' and Adafactor, in both packages from the same weights,
    projection and batches; the latent noise pinned out (logvar at -80)."""
    from deepl_project_tpu import get_config as jax_get_config
    from deepl_project_tpu.losses import teachers as jax_teachers
    from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
    from deepl_project_tpu.models.transvae import TransVAE as JaxTransVAE
    from deepl_project_tpu.training.train_step import _loss_and_metrics as jax_loss_and_metrics
    from jax.sharding import NamedSharding, PartitionSpec
    from deepl_project_tpu.training.train_step import init_train_state
    from deepl_project_tpu.training.trainer import Trainer as JaxTrainer
    from deepl_project_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
    from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
    from deepl_project_tpu.utils.convert import torch_state_dict_to_params
    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.losses.teachers import make_stub_teacher
    from deepl_project_tpu_torch.models import TransVAE, init_weights
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.utils.convert import load_jax_params

    torch.set_num_threads(2)
    src = TransVAE(get_config(VARIANT, **MICRO), device="cpu")
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    sd["conv_logvar.bias"] = np.full_like(sd["conv_logvar.bias"], -200.0)
    jcfg = jax_get_config(VARIANT, **MICRO, remat=True)
    params = torch_state_dict_to_params(sd, jcfg)
    rng = np.random.default_rng(7)
    vf = {"kernel": (rng.standard_normal((4, 8)) / 2).astype(np.float32),
          "bias": np.zeros(8, np.float32)}
    batches = [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2)]
    weights = dict(l1=1.0, lpips=0.0, kl=1e-2, vf=0.1, gan=0.0)

    jteacher = jax_teachers.make_stub_teacher(**TEACHER)
    jt = JaxTrainer(jcfg, JaxTrainerConfig(**_trainer_kw(tmp_path / "jax"),
                                           weights=JaxLossWeights(**weights)),
                    teacher_fn=jteacher)
    # The whole state replicated on the trainer's mesh, as its steps leave
    # it: the first step's compile then serves the second.
    jstate = init_train_state({"model": params, "vf_proj": vf}, jt.tx)
    jstate = jax.device_put(jstate, NamedSharding(jt.mesh, PartitionSpec()))
    jstate = jt.fit(iter(batches), state=jstate)

    teacher = make_stub_teacher(**TEACHER, proj=_jax_stub_proj(8, 4, TEACHER["seed"]))
    pt = Trainer(get_config(VARIANT, **MICRO, remat=True),
                 TrainerConfig(**_trainer_kw(tmp_path / "port"), weights=LossWeights(**weights)),
                 teacher_fn=teacher, device="cpu")
    state = pt.create_state()
    assert state.model.config.remat and state.model.config.remat_policy == "dots"
    load_jax_params(state.model, params)
    with torch.no_grad():
        state.vf_proj.kernel.copy_(torch.from_numpy(vf["kernel"]))
        state.vf_proj.bias.zero_()
    state = pt.fit(iter(batches), state=state)
    assert state.step == int(jstate.step) == 2

    import json
    rows = {side: [json.loads(line) for line in open(tmp_path / side / "history.jsonl")]
            for side in ("jax", "port")}
    for j, p in zip(rows["jax"], rows["port"], strict=True):
        assert p["step"] == j["step"] and p["vf"] > 0
        for k in ("total", "l1", "kl", "vf", "grad_norm"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=f"step {p['step']} {k}")
    # Parameters after, entry by entry. Adafactor divides each update by the
    # gradient's RMS, so an entry's update carries its gradient's relative
    # error: the first update of an unfactored entry is lr * sign(g), and
    # one whose gradient is rounding noise (a bias before a GroupNorm has a
    # true gradient of 0) moves by +-lr on either side at random, then by up
    # to lr / sqrt(1 - d) = 1.32 lr at the second step (d = 1 - 2^-0.8):
    # 4.64 lr apart at most. Each entry is held to lr * (1e-3 + 4.64 *
    # min(1, eps / |g1|)), g1 its first-step gradient by jax.grad and eps =
    # 2^-23 x max |g1| (fp32 rounding of the largest gradient): an entry
    # whose gradient stands above the noise is held to ~1e-3 lr.
    def jax_loss(p):
        return jax_loss_and_metrics(JaxTransVAE(jcfg), p, batches[0], jax.random.PRNGKey(0),
                                    JaxLossWeights(**weights), None, jteacher, None)[0]

    g1 = jax.jit(jax.grad(jax_loss))({"model": params, "vf_proj": vf})
    g1 = {**jax_to_sd(jax.tree_util.tree_map(np.asarray, g1["model"]), None),
          **{f"vf_proj.{k}": np.asarray(v) for k, v in g1["vf_proj"].items()}}
    eps = 2.0 ** -23 * max(np.abs(g).max() for g in g1.values())
    lr = 1e-3
    want = jax_to_sd(jax.tree_util.tree_map(np.asarray, jstate.params["model"]), None)
    want["vf_proj.kernel"] = np.asarray(jstate.params["vf_proj"]["kernel"])
    want["vf_proj.bias"] = np.asarray(jstate.params["vf_proj"]["bias"])
    got = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
    got.update({f"vf_proj.{n}": p.detach().numpy() for n, p in state.vf_proj.named_parameters()})
    assert set(got) == set(want) == set(g1)
    for n in got:
        err = np.abs(got[n] - want[n])
        bound = lr * (1e-3 + 4.64 * np.minimum(1.0, eps / np.maximum(np.abs(g1[n]), 1e-38)))
        assert (err <= bound).all(), (n, (err / bound).max())
    moved = np.concatenate([np.abs(got[n] - sd.get(n, want[n])).ravel()
                            for n in got if n in sd])
    assert np.median(moved) > 0.5 * lr  # the steps moved the parameters
    assert np.abs(got["vf_proj.kernel"] - vf["kernel"]).max() > 0.5 * lr
    np.testing.assert_allclose(got["vf_proj.kernel"], want["vf_proj.kernel"], rtol=0,
                               atol=1e-3 * lr)


def test_vf_proj_and_adafactor_state_survive_save_and_resume(tmp_path, capsys):
    """A run with VF, EMA and Adafactor saves vf_proj, the Adafactor state
    and the EMA of both; the same trainer resumes all of it. Resuming the
    checkpoint with AdamW is a hand-off: model, step and vf_proj restored,
    a fresh optimizer (the JAX trainer's failed structured restore)."""
    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.data import batch_iterator, make_dataset
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.losses.teachers import make_stub_teacher
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig, restore_checkpoint

    torch.set_num_threads(2)

    def trainer(opt):
        kw = _trainer_kw(tmp_path, ema_decay=0.9)
        kw["optimizer"] = opt
        return Trainer(get_config(VARIANT, **MICRO),
                       TrainerConfig(**kw, weights=LossWeights(lpips=0.0, gan=0.0, vf=0.1)),
                       teacher_fn=make_stub_teacher(**TEACHER), device="cpu")

    def data():
        return batch_iterator(make_dataset("shapes", resolution=32, num_samples=40), 2)

    state = trainer("adafactor").fit(data())
    saved, _ = restore_checkpoint(str(tmp_path / "checkpoints"))
    assert {"model", "optimizer", "step", "ema", "vf_proj"} == set(saved)
    assert saved["optimizer"]["kind"] == "adafactor" and saved["optimizer"]["count"] == 2
    assert {"vf_proj.kernel", "vf_proj.bias"} <= set(saved["optimizer"]["v"])
    assert {"vf_proj.kernel", "vf_proj.bias"} <= set(saved["ema"])
    assert torch.equal(saved["vf_proj"]["kernel"], state.vf_proj.kernel.detach())

    resumed = trainer("adafactor")
    rstate, _ = resumed.maybe_resume(resumed.create_state())
    assert rstate.step == 2 and rstate.optimizer.count == 2
    assert torch.equal(rstate.vf_proj.kernel, state.vf_proj.kernel)
    for key in ("v", "v_row", "v_col"):
        for n, t in rstate.optimizer.state_dict()[key].items():
            assert torch.equal(t, saved["optimizer"][key][n]), n
    for n, t in rstate.ema.items():
        assert torch.equal(t, state.ema[n]), n
    batch = torch.from_numpy(next(data()))
    resumed.step_fn(rstate, batch)
    assert rstate.step == 3 and rstate.optimizer.count == 3
    capsys.readouterr()

    handoff = trainer("adamw")
    hstate, _ = handoff.maybe_resume(handoff.create_state())
    assert "structured restore failed" in capsys.readouterr().out
    assert hstate.step == 2 and hstate.optimizer.count == 0
    assert not any(m.any() for m in hstate.optimizer.mu if m is not None)
    assert torch.equal(hstate.vf_proj.kernel, state.vf_proj.kernel)
    # The EMA restarts from the restored parameters, vf_proj's included.
    assert torch.equal(hstate.ema["vf_proj.kernel"], hstate.vf_proj.kernel)
    assert torch.equal(hstate.ema["decoder.conv_out.weight"],
                       hstate.model.decoder.conv_out.weight)
    handoff.step_fn(hstate, batch)
    assert hstate.step == 3 and hstate.optimizer.count == 1


def test_vf_proj_joins_the_resume_rule(tmp_path, capsys):
    """A checkpoint without vf_proj resumed by a trainer with a teacher is a
    hand-off (the live keys hold vf_proj): model and step restored, the
    optimizer fresh, vf_proj as made; the reverse restores the model too."""
    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.losses.teachers import make_stub_teacher
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig

    torch.set_num_threads(2)

    def trainer(teacher):
        kw = _trainer_kw(tmp_path)
        kw["optimizer"] = "adamw"
        return Trainer(get_config(VARIANT, **MICRO),
                       TrainerConfig(**kw, weights=LossWeights(lpips=0.0, gan=0.0, vf=0.1)),
                       teacher_fn=make_stub_teacher(**TEACHER) if teacher else None,
                       device="cpu")

    plain = trainer(False)
    state = plain.create_state()
    state.step = 3
    plain.save(state, epoch=0)
    capsys.readouterr()
    vf = trainer(True)
    fresh = vf.create_state()
    made = fresh.vf_proj.kernel.detach().clone()
    resumed, _ = vf.maybe_resume(fresh)
    assert "do not match the live state" in capsys.readouterr().out
    assert resumed.step == 3 and resumed.optimizer.count == 0
    assert torch.equal(resumed.vf_proj.kernel, made)
    assert torch.equal(resumed.model.decoder.conv_out.weight, state.model.decoder.conv_out.weight)
    vf.save(resumed, epoch=0)
    back, _ = trainer(False).maybe_resume(trainer(False).create_state())
    assert "do not match the live state" in capsys.readouterr().out and back.step == 3
