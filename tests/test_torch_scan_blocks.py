"""The port's scan layout (``scan_blocks``, ``ops/stack.py``) against the JAX
package's, and against the port's own unrolled model, on the CPU.

The micro model is the JAX package's scan-equivalence model
(``tests/test_model.py::test_scan_blocks_equivalence``): tiny f16d32 cut to
three stages, two blocks a stage, so every stack has a depth of 2.

- The state_dict: JAX ``TransVAE(scan_blocks=True)``'s init tree loads into
  the port's scan model with ``strict=True`` and comes back leaf for leaf
  (the port's unstack, JAX's ``torch_state_dict_to_params`` and
  ``to_scanned_params``).
- The forward against JAX's scan model in fp32 and bf16, on the same
  parameters (the tolerances of ``tests/test_torch_model.py``).
- Against the port's unrolled model from the same seed: the seeded init is
  the scan conversion of the unrolled one, forward and gradients bit-equal,
  also under each remat policy.
- One AdamW step against JAX's scan step (loss, grad norm, params); three
  Adafactor steps on the stacked shapes against optax's on JAX's scan tree
  and on its unrolled tree: optax clips each leaf's update by its RMS, so a
  stage's stack is clipped as one block, and the port's two layouts differ
  by what JAX's two differ by.
- The operand cache keeps one fold per depth slice; a Trainer checkpoint in
  the scan layout reloads, converts to the unrolled model, serves, and is
  refused by int8 quantization with JAX's message; a Trainer of the other
  layout resumes it with its EMA and AdamW moments; the train CLI runs
  ``--scan_blocks --gradient_checkpointing --optimizer adafactor``.

Tolerances: forward fp32 atol 5e-4 + rtol 1e-4, bf16 0.05 x max|ref| (as
test_torch_model.py); the AdamW step's loss and grad norm 1e-5 relative,
params 1e-6 + 1e-5 relative, except entries whose gradient is within 1e-4
of the largest of zero (an Adam first step moves an entry by lr g / (|g| +
eps), its sign alone), held to 2 lr; Adafactor 1e-6 absolute on parameters
that three steps move by ~0.1 (1e-5 of the change: the global-norm clip
sums the whole model's squares in another order than optax), the two
layouts' gap 2e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import _factored_dims as optax_factored_dims

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.losses.vae_loss import transvae_loss as jax_transvae_loss
from deepl_project_tpu.ops.stack import to_scanned_params as jax_to_scanned
from deepl_project_tpu.training.optim import make_optimizer as jax_make_optimizer
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import create_transvae, get_config
from deepl_project_tpu_torch.cli import train as train_cli
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.models import TransVAE, enable_gradient_checkpointing
from deepl_project_tpu_torch.ops.stack import (BlockStack, from_scanned_params, is_scanned,
                                               stack_stage_params, to_scanned_params,
                                               unstack_stage_params)
from deepl_project_tpu_torch.training import make_optimizer
from deepl_project_tpu_torch.training.optim import factored_dims, jax_layout
from deepl_project_tpu_torch.training.train_step import (compute_grads, global_norm,
                                                         named_trainables)
from deepl_project_tpu_torch.utils.convert import (load_jax_params, load_state_dict,
                                                   params_to_torch_state_dict)

torch.set_num_threads(2)
VARIANT = "tiny_f16d32"
MICRO = dict(depths=(2, 2, 2), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
             dtype="float32", attention_impl="auto_train")
WEIGHTS = dict(l1=1.0, lpips=0.0, kl=1e-2, vf=0.0, gan=0.0)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _numpy(sd) -> dict:
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def _jax_scan_tree(sd_scan: dict, **kw) -> dict:
    """A port scan state_dict as JAX's scan tree: the port's unstack, then
    the JAX package's converter and stacker."""
    jcfg = jax_get_config(VARIANT, **{**MICRO, **kw})
    port_cfg = get_config(VARIANT, **{**MICRO, **kw})
    flat = _numpy(from_scanned_params(sd_scan, port_cfg))
    return jax.jit(lambda t: jax_to_scanned(t, jcfg))(torch_state_dict_to_params(flat, jcfg))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_tree():
    """A tree of JAX ``TransVAE(scan_blocks=True)``'s init: its structure and
    shapes (``jax.eval_shape``, no compile), seeded numpy leaves."""
    jm = JaxTransVAE(jax_get_config(VARIANT, **MICRO, scan_blocks=True))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "sample": key},
                                            jnp.zeros((1, 16, 16, 3))))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_state_dict_round_trips_the_jax_scan_tree(jax_tree):
    tree = jax_tree
    cfg = get_config(VARIANT, **MICRO, scan_blocks=True)
    port = TransVAE(cfg, device="cpu")
    sd = params_to_torch_state_dict(tree)
    port.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=True)
    stacked = [k for k in sd if ".scan.block." in k]
    assert "encoder.stages.2.scan.block.attn.to_q.weight" in stacked
    assert port.encoder.stages[2].scan.block.attn.to_q.weight.shape == (2, 32, 32)
    assert isinstance(port.decoder.stages[0], BlockStack)
    back = _jax_scan_tree(port.state_dict())
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=str(path))
    # jax_layout (the optimizer's and the placements' view of a parameter)
    # gives each port tensor the JAX leaf's layout, stacks included: the
    # leaves are told apart by converting a tree of their indices.
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    index = params_to_torch_state_dict(jax.tree_util.tree_unflatten(
        treedef, [np.full(a.shape, k, np.float32) for k, a in enumerate(leaves)]))
    for name, a in sd.items():
        want = leaves[int(index[name].flat[0])]
        np.testing.assert_array_equal(np.transpose(a, jax_layout(name, a.shape)), want,
                                      err_msg=name)
    # The stage helpers invert each other on one stage.
    one = stack_stage_params(unstack_stage_params(sd, "encoder.stages.1", 2),
                             "encoder.stages.1", 2)
    assert list(one) == list(sd)
    # The unrolled model takes the scan tree through the converter.
    unrolled = TransVAE(get_config(VARIANT, **MICRO), device="cpu")
    load_jax_params(unrolled, tree)
    for k, v in from_scanned_params(port.state_dict(), cfg).items():
        torch.testing.assert_close(unrolled.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_scan_model(dtype):
    port = create_transvae(VARIANT, device="cpu", seed=1, scan_blocks=True,
                           **{**MICRO, "dtype": dtype})
    tree = _jax_scan_tree(port.state_dict(), dtype=dtype)
    jm = JaxTransVAE(jax_get_config(VARIANT, **{**MICRO, "dtype": dtype}, scan_blocks=True))
    x = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, sample=False))(tree, x)
    with torch.inference_mode():
        got = port(_nchw(x), sample=False)
    for r, g in zip(ref, got):
        r = np.asarray(r.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(_nhwc(g), r, atol=5e-4, rtol=1e-4)
        else:
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(_nhwc(g), r, atol=0.05 * np.abs(r).max(), rtol=0)


def _grads(model, x):
    grads, metrics = compute_grads(model, x, LossWeights(**WEIGHTS), sample=False)
    return dict(zip([n for n, _ in named_trainables(model)], grads)), metrics


def test_scan_model_is_the_unrolled_model_bit_for_bit():
    unrolled = create_transvae(VARIANT, device="cpu", seed=4, **MICRO)
    scan = create_transvae(VARIANT, device="cpu", seed=4, scan_blocks=True, **MICRO)
    # The seeded init: slice j of a stack holds block j's draws.
    want = to_scanned_params(unrolled.state_dict(), unrolled.config)
    assert list(scan.state_dict()) == list(want)
    for k, v in scan.state_dict().items():
        assert torch.equal(v, want[k]), k
    x = torch.from_numpy(np.random.default_rng(5).random((2, 32, 32, 3), dtype=np.float32))
    with torch.no_grad():
        for a, b in zip(unrolled(_nchw(x.numpy())), scan(_nchw(x.numpy()))):
            assert torch.equal(a, b)
    ga, ma = _grads(unrolled, x)
    gb, mb = _grads(scan, x)
    assert float(ma["total"]) == float(mb["total"])
    for k, g in from_scanned_params(gb, scan.config).items():
        assert torch.equal(g, ga[k]), k


@pytest.mark.parametrize("policy", ["none", "dots", "dots_all", "conv_dots"])
def test_remat_policies_give_the_no_remat_gradients(policy):
    scan = create_transvae(VARIANT, device="cpu", seed=6, scan_blocks=True, **MICRO)
    remat = enable_gradient_checkpointing(scan, policy)
    assert remat.config.remat and remat.encoder.stages[2].remat
    assert remat.encoder.stages[2].scan.block.attn.to_q.weight is \
        scan.encoder.stages[2].scan.block.attn.to_q.weight
    x = torch.from_numpy(np.random.default_rng(7).random((2, 32, 32, 3), dtype=np.float32))
    ref, mref = _grads(scan, x)
    got, mgot = _grads(remat, x)
    top = max(float(g.abs().max()) for g in ref.values())
    assert float(mgot["total"]) == float(mref["total"])
    for k in ref:
        _close(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-6 * top)


LR = 1e-3


@pytest.fixture(scope="module")
def adamw_pair():
    """(port scan model, batch, JAX loss, grad norm, grads and params after
    one AdamW step in the port's layout) from the same weights."""
    port = create_transvae(VARIANT, device="cpu", seed=8, scan_blocks=True, **MICRO)
    tree = _jax_scan_tree(port.state_dict())
    batch = np.random.default_rng(9).random((2, 32, 32, 3), dtype=np.float32)
    jm = JaxTransVAE(jax_get_config(VARIANT, **MICRO, scan_blocks=True))

    def loss_fn(p):
        recon, mu, logvar = jm.apply({"params": p}, batch, sample=False)
        return jax_transvae_loss(recon, batch, mu, logvar, JaxLossWeights(**WEIGHTS))["total"]

    loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    tx = jax_make_optimizer(learning_rate=LR, warmup_steps=0, max_grad_norm=1.0)

    @jax.jit
    def step(g, p):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    new = step(jgrads, tree)
    as_sd = lambda t: params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return (port, batch, float(loss), float(optax.global_norm(jgrads)), as_sd(jgrads),
            as_sd(new))


def test_adamw_step_matches_jax_scan_step(adamw_pair):
    port, batch, loss, jnorm, jg, jnew = adamw_pair
    named = named_trainables(port)
    grads, metrics = compute_grads(port, torch.from_numpy(batch), LossWeights(**WEIGHTS),
                                   sample=False)
    norm = float(global_norm(grads))
    opt = make_optimizer(named, learning_rate=LR, warmup_steps=0, max_grad_norm=1.0)
    assert opt.step(grads)
    _close(float(metrics["total"]), loss, rtol=1e-5)
    _close(norm, jnorm, rtol=1e-5)
    top = max(np.abs(g).max() for g in jg.values())
    for name, p in named:
        got, want = p.detach().numpy(), jnew[name]
        near_zero = np.abs(jg[name]) <= 1e-4 * top
        bad = (np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)) & ~near_zero
        assert not bad.any(), name
        assert (np.abs(got - want) <= 2 * LR).all(), name


# The Adafactor check's model: the micro model with a 128-wide last stage, so
# the stacks hold factored kernels too (optax factors from 128).
WIDE = dict(base_dims=(16, 16, 128))
ADAFACTOR = dict(learning_rate=0.05, warmup_steps=2, max_grad_norm=1.0, optimizer="adafactor")


def _port_adafactor(named_arrays: dict, grads: list) -> dict:
    """The port's Adafactor, three steps on port-layout arrays."""
    tensors = [(n, torch.from_numpy(a.copy())) for n, a in named_arrays.items()]
    opt = make_optimizer(tensors, **ADAFACTOR)
    for g in grads:
        assert opt.step([torch.from_numpy(g[n].copy()) for n, _ in tensors])
    return {n: t.numpy() for n, t in tensors}


def _optax_adafactor(tree, grads: list) -> dict:
    """optax's (the JAX package's chain), the same steps on a JAX tree; the
    result in the port's layout."""
    tx = jax_make_optimizer(**ADAFACTOR)

    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    state = jax.jit(tx.init)(tree)
    for g in grads:
        tree, state = update(g, state, tree)
    return params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def adafactor_case():
    """Values and three gradients in the scan layout of the wide micro model
    (within a stack the slices' gradient scales differ, and differ again
    from step to step), and optax's three steps on JAX's scan tree and on
    its unrolled tree of them."""
    cfg = get_config(VARIANT, **{**MICRO, **WIDE})
    jcfg = jax_get_config(VARIANT, **{**MICRO, **WIDE})
    with torch.device("meta"):
        scan = TransVAE(cfg.replace(scan_blocks=True))
    shapes = {n: tuple(p.shape) for n, p in scan.named_parameters()}
    rng = np.random.default_rng(11)
    params = {n: (0.1 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}

    def grad(scales):
        out = {}
        for n, s in shapes.items():
            g = rng.standard_normal(s).astype(np.float32)
            if ".scan.block." in n:
                g *= np.asarray(scales, np.float32).reshape((-1,) + (1,) * (len(s) - 1))
            out[n] = g
        return out

    grads = [grad([1.0, 1.0]), grad([5.0, 0.2]), grad([0.1, 3.0])]
    flat = lambda sd: torch_state_dict_to_params(from_scanned_params(sd, cfg), jcfg)  # noqa: E731
    stack = jax.jit(lambda tree: jax_to_scanned(tree, jcfg))
    jax_scan = _optax_adafactor(stack(flat(params)), [stack(flat(g)) for g in grads])
    jax_flat = _optax_adafactor(flat(params), [flat(g) for g in grads])
    return scan, cfg, params, grads, jax_scan, jax_flat


def test_adafactor_clips_a_stack_as_one_block_as_jax_does(adafactor_case):
    scan, cfg, params, grads, jax_scan, jax_flat = adafactor_case
    # Factored dims on the stacked shapes: optax's on the JAX stacked leaf.
    factored = 0
    for name, p in scan.named_parameters():
        axes = jax_layout(name, p.shape)
        want = optax_factored_dims(tuple(p.shape[a] for a in axes), True, 128)
        got = factored_dims(name, p.shape)
        assert (None if got is None else (axes.index(got[0]), axes.index(got[1]))) == want, name
        factored += want is not None and ".scan.block." in name
    assert factored >= 4
    unroll = lambda sd: {k: np.ascontiguousarray(v)  # noqa: E731
                         for k, v in from_scanned_params(sd, cfg).items()}
    port_scan = _port_adafactor(params, grads)
    port_flat = _port_adafactor(unroll(params), [unroll(g) for g in grads])
    for port_sd, jax_sd in ((port_scan, jax_scan), (port_flat, jax_flat)):
        assert set(port_sd) == set(jax_sd)
        for name in port_sd:
            _close(port_sd[name], jax_sd[name], rtol=0, atol=1e-6)
    # JAX's own layouts differ (the whole-stack clip); the port's two differ
    # by the same amount, entry for entry.
    jax_gap = {k: v - jax_flat[k] for k, v in unroll(jax_scan).items()}
    port_gap = {k: v - port_flat[k] for k, v in unroll(port_scan).items()}
    assert max(np.abs(v).max() for v in jax_gap.values()) > 1e-3
    for k in jax_gap:
        _close(port_gap[k], jax_gap[k], rtol=0, atol=2e-6)


def test_operand_cache_keeps_a_fold_per_depth_slice():
    model = create_transvae(VARIANT, device="cpu", seed=12, scan_blocks=True, **MICRO)
    ffn = model.encoder.stages[2].scan.block.ffn
    x = _nchw(np.random.default_rng(13).random((1, 32, 32, 3), dtype=np.float32))

    def folds():
        return {k[1]: v[1] for k, v in ffn.__dict__.get("_operand_cache", {}).items()
                if k[0][0] == "fold"}

    with torch.no_grad():
        first = model(x)[0]
        made = folds()
        model(x)
        again = folds()
    assert sorted(made) == [0, 1]  # one entry a slice, bounded by depth
    assert all(again[j] is made[j] for j in made)  # made once across forwards
    # Each slice's operands are its own block's.
    assert not torch.equal(made[0][1], made[1][1])
    weight = ffn.proj_out.weight  # the [depth, ...] stack
    kept = weight.detach().clone()
    with torch.no_grad():
        weight.add_(1.0)  # in place, on the whole stack
        model(x)
        fresh = folds()
        weight.copy_(kept)
        back = model(x)[0]
    assert all(fresh[j] is not made[j] for j in made)
    assert torch.equal(back, first)


def test_trainer_checkpoint_reloads_converts_and_serves(tmp_path):
    from deepl_project_tpu_torch.data import batch_iterator, make_dataset
    from deepl_project_tpu_torch.evaluation import model_from_checkpoint, reconstruct
    from deepl_project_tpu_torch.quantize import quantize_model
    from deepl_project_tpu_torch.serving import InferenceEngine
    from deepl_project_tpu_torch.training import (Trainer, TrainerConfig, load_config,
                                                  restore_model_params)

    cfg = get_config(VARIANT, **MICRO, scan_blocks=True)
    tc = TrainerConfig(batch_size=2, warmup_steps=1, num_epochs=1, steps_per_epoch=2,
                       log_every=1, resolution=32, output_dir=str(tmp_path),
                       weights=LossWeights(gan=0.0), save_every_epochs=1, seed=1,
                       ema_decay=0.9, freeze_encoder=True)
    trainer = Trainer(cfg, tc, device="cpu")
    state = trainer.create_state()
    enc = state.model.encoder.stages[0].scan.block.conv1.weight.detach().clone()
    state = trainer.fit(batch_iterator(make_dataset("shapes", resolution=32, num_samples=8), 2),
                        state=state)
    assert state.step == 2
    # The stage-2 freeze holds on the stacked encoder keys; EMA keeps them.
    assert torch.equal(enc, state.model.encoder.stages[0].scan.block.conv1.weight)
    assert "encoder.stages.0.scan.block.conv1.weight" in state.ema
    ckpt = str(tmp_path / "checkpoints")
    assert load_config(ckpt).scan_blocks
    saved = restore_model_params(ckpt, prefer_ema=False)
    assert "decoder.stages.2.scan.block.conv2.weight" in saved
    scan = model_from_checkpoint(ckpt, "cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(scan.state_dict()[k], v), k
    unrolled = TransVAE(cfg.replace(scan_blocks=False), device="cpu").eval()
    load_state_dict(unrolled, saved)
    images = np.random.default_rng(14).random((2, 32, 32, 3), dtype=np.float32)
    want = reconstruct(unrolled, None, images)
    np.testing.assert_array_equal(reconstruct(scan, None, images), want)
    served = InferenceEngine(scan, max_batch=2).run("reconstruct", images)
    np.testing.assert_allclose(served, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="does not support scan_blocks param layouts"):
        quantize_model(scan, [images])


@pytest.mark.parametrize("optimizer,scan_first", [("adamw", True), ("adamw", False),
                                                   ("adafactor", True)])
def test_trainer_resumes_the_other_layout_with_its_ema(tmp_path, optimizer, scan_first):
    """A checkpoint resumed by a Trainer of the other block layout: its EMA
    and AdamW's moments are converted, not reset; Adafactor's factored
    state is not carried over, so the optimizer starts afresh and the EMA
    restarts from the restored parameters (the stage hand-off's rule)."""
    from deepl_project_tpu_torch.data import batch_iterator, make_dataset
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.utils.convert import in_model_layout

    cfg = get_config(VARIANT, **MICRO, scan_blocks=scan_first)
    tc = TrainerConfig(batch_size=2, warmup_steps=1, num_epochs=1, steps_per_epoch=1,
                       log_every=1, resolution=32, output_dir=str(tmp_path),
                       weights=LossWeights(gan=0.0), save_every_epochs=1, seed=1,
                       ema_decay=0.9, optimizer=optimizer)
    first = Trainer(cfg, tc, device="cpu")
    done = first.fit(batch_iterator(make_dataset("shapes", resolution=32, num_samples=4), 2),
                     state=first.create_state())
    other = Trainer(cfg.replace(scan_blocks=not scan_first), tc, device="cpu")
    state, _ = other.maybe_resume(other.create_state())
    assert state.step == 1 and is_scanned(state.ema) == (not scan_first)
    params = dict(named_trainables(state.model))
    if optimizer == "adafactor":
        assert state.optimizer.count == 0
        assert all(torch.equal(state.ema[k], params[k]) for k in params)
        return
    ema = in_model_layout(state.model, done.ema)
    assert set(state.ema) == set(ema) and not all(torch.equal(ema[k], params[k]) for k in ema)
    assert all(torch.equal(state.ema[k], v) for k, v in ema.items())
    saved, got = done.optimizer.state_dict(), state.optimizer.state_dict()
    assert got["count"] == saved["count"] == 1
    for key in ("mu", "nu"):
        want = in_model_layout(state.model, saved[key])
        assert set(got[key]) == set(want)
        assert all(torch.equal(got[key][k], v) for k, v in want.items())


def test_train_cli_runs_the_big_model_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(train_cli, "get_config",
                        lambda *a, **kw: get_config(VARIANT, **{**kw, **MICRO}))
    out = tmp_path / "run"
    train_cli.main(["--scan_blocks", "--gradient_checkpointing", "--optimizer", "adafactor",
                    "--data", "shapes", "--resolution", "32", "--batch_size", "2",
                    "--num_epochs", "1", "--steps_per_epoch", "2", "--log_every", "1",
                    "--warmup_steps", "1", "--device", "cpu", "--output_dir", str(out)])
    rows = [json.loads(line) for line in open(out / "history.jsonl")]
    assert [r["step"] for r in rows if r["kind"] == "train"] == [1, 2]
    assert all(np.isfinite(r["total"]) for r in rows if r["kind"] == "train")
    with open(out / "checkpoints" / "config.json") as f:
        saved = json.load(f)
    assert saved["scan_blocks"] is True and saved["remat"] is True


def test_placements_and_context_of_the_scan_layout(monkeypatch):
    """Every placement takes a scan model: replicated as it is, and under
    FSDP and tensor parallelism by the JAX rules on the stacked shapes
    (tests/test_torch_scan_parallel.py holds them to JAX's and runs them);
    a stack's depth axis is never split under 'tensor'. An ambient context
    group is accepted, and refused only for what it refuses in an unrolled
    model (here a height the downsample factor does not divide: JAX's
    refusal)."""
    from deepl_project_tpu_torch.models import transvae
    from deepl_project_tpu_torch.parallel.context import ContextState
    from deepl_project_tpu_torch.parallel.mesh import Replicate, Shard
    from deepl_project_tpu_torch.parallel.sharding import param_specs

    with torch.device("meta"):
        scan = TransVAE(get_config(VARIANT, **MICRO, scan_blocks=True,
                                   context_axis="context"))
    specs = param_specs(scan, "replicate", model_size=2)
    assert set(specs) == {n for n, _ in scan.named_parameters()}
    assert all(isinstance(s, Replicate) for s in specs.values())
    for mode in ("fsdp", "tensor"):
        specs = param_specs(scan, mode, model_size=2, fsdp_min_size=1024)
        stacked = {k: s for k, s in specs.items() if ".scan.block." in k}
        assert any(isinstance(s, Shard) for s in stacked.values()), mode
        if mode == "tensor":
            assert all(s.dim != 0 for s in stacked.values() if isinstance(s, Shard))
    monkeypatch.setattr(transvae.cp, "current", lambda: ContextState(None, 0, 2))
    with pytest.raises(ValueError, match="downsample factor 4"):  # 2 ranks x 17 rows
        scan.encode(torch.zeros(1, 3, 17, 16, device="meta"))
