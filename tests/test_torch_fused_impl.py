"""``AttentionRoPE(fuse_qkv=True)`` and ``impl='fused'`` of the port against
the JAX package's ``ops/attention.py`` on the CPU.

Each JAX module's parameters are drawn with numpy on its init's shapes
(weights of std 0.1, so that attention is far from uniform; LayerNorm
affines and the projection bias away from their init), converted with the
port's ``params_to_torch_state_dict`` and loaded into the port's module
with strict=True; both run on the same seeded numpy input (NHWC for JAX,
NCHW for the port).

- ``fuse_qkv``: the folded QKV (one shared-statistics normalisation, one
  [C, 3C] product) against JAX's at impl 'xla', forward in fp32 and bf16
  and the gradients of x and every parameter; the parameter tree the same
  with and without the fold in both packages; both kernel routes off; the
  fold rebuilt after an in-place update of any of its nine parameters;
  under tensor parallelism (two gloo ranks, tests/torch_parallel_jobs.py)
  the micro model's step against one process.
- ``impl='fused'``: ``AttentionRoPE`` at the sublayer kernel's shape
  (N = 256) and the ``ln_qkv_rope`` shape (N = 2048) and the DiT, in fp32
  and bf16, against JAX's 'fused'; the port's routes equal to its 'auto'
  routes (on the CPU the bf16 kernel routes run the kernels' plain
  versions) and its output bit-equal to 'auto''s on the CPU, where both
  take the plain core; the core it picks at N = 4096; a Trainer
  checkpoint keeps 'fused' in its saved config.

Tolerances: fp32 1e-4 rel and 1e-5 abs (the JAX test's for the fold: sums
in other orders); gradients 1e-4 x max|grad|; bf16 2^-6 x max|ref| (two
bf16 rounding steps at the largest magnitude, the bar of the port's 'auto'
tests); the DiT's bars are those of tests/test_torch_dit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_jobs as J
from deepl_project_tpu.ops.attention import AttentionRoPE as JaxAttentionRoPE
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.ops import attention as attn_mod
from deepl_project_tpu_torch.ops.attention import AttentionRoPE
from deepl_project_tpu_torch.training import Trainer, TrainerConfig, load_config
from deepl_project_tpu_torch.utils.convert import load_state_dict, params_to_torch_state_dict

from dit_parity import inputs, jax_forward, make_pair, torch_args

torch.set_num_threads(2)
C, HD = 128, 64
RTOL, ATOL = 1e-4, 1e-5
BF16 = 2 ** -6


def _params(jm, h, w, seed):
    """A param tree of the JAX module's shapes (``jax.eval_shape`` of its
    init: no compile), drawn with numpy: weights N(0, 0.1^2), LayerNorm
    scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, h, w, jm.dim)))["params"])
    rng = np.random.default_rng(seed)

    def draw(path, s):
        shift = 1.0 if path[-1].key == "scale" else 0.0
        return (shift + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(impl, fuse_qkv, dtype="float32", h=8, w=8, seed=0):
    """(JAX module, its params, the port's module holding them)."""
    jm = JaxAttentionRoPE(C, head_dim=HD, impl=impl, fuse_qkv=fuse_qkv,
                          dtype=jnp.dtype(dtype), param_dtype=jnp.float32)
    params = _params(jm, h, w, seed)
    pm = AttentionRoPE(C, HD, impl=impl, fuse_qkv=fuse_qkv)
    load_state_dict(pm, params_to_torch_state_dict(params))
    return jm, params, pm


def _x(h, w, seed=2):
    return np.random.default_rng(seed).standard_normal((2, h, w, C)).astype(np.float32)


def _run(jm, params, pm, x, dtype):
    """(JAX output, port output) as fp32 NHWC numpy."""
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jx).astype(jnp.float32))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with torch.no_grad():
        got = pm(tx)
    assert got.dtype == tx.dtype
    return want, got.float().permute(0, 2, 3, 1).numpy()


def _close(got, want, dtype):
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=BF16 * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- fuse_qkv -------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_qkv_matches_jax(dtype):
    jm, params, pm = _pair("xla", True, dtype)
    x = _x(8, 8)
    want, got = _run(jm, params, pm, x, dtype)
    _close(got, want, dtype)
    if dtype == "float32":
        # The fold against the three separate norms and products on the same
        # parameters, in both packages (the JAX test's case).
        jplain = JaxAttentionRoPE(C, head_dim=HD, impl="xla", dtype=jnp.float32)
        plain = AttentionRoPE(C, HD, impl="xla")
        plain.load_state_dict(pm.state_dict(), strict=True)
        want_plain, got_plain = _run(jplain, params, plain, x, dtype)
        _close(got, got_plain, dtype)
        _close(want, want_plain, dtype)


def test_fuse_qkv_keeps_the_parameter_tree():
    jfused, params, fused = _pair("xla", True)
    jplain, _, plain = _pair("xla", False)
    x = jnp.zeros((1, 8, 8, C))
    assert (jax.tree_util.tree_structure(jax.eval_shape(jfused.init, jax.random.PRNGKey(0), x))
            == jax.tree_util.tree_structure(jax.eval_shape(jplain.init, jax.random.PRNGKey(0),
                                                           x)))
    assert set(fused.state_dict()) == set(plain.state_dict()) == set(
        params_to_torch_state_dict(params))
    for name, t in fused.state_dict().items():
        assert t.shape == plain.state_dict()[name].shape, name


def test_fuse_qkv_gradients_match_jax():
    # d/dx and d/dparam of the fold (the training route) against jax.vjp
    # of JAX's fused module, fp32; the parameters' through the converter.
    jm, params, pm = _pair("xla", True)
    x = _x(8, 8, seed=3)
    ct = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    gp, gx = jax.jit(lambda p, xx, c: jax.vjp(lambda p, xx: jm.apply({"params": p}, xx),
                                              p, xx)[1](c))(params, jnp.asarray(x),
                                                            jnp.asarray(ct))
    want = {"x": np.asarray(gx), **params_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, gp))}
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    pm(tx).backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    got = {"x": tx.grad.permute(0, 2, 3, 1).numpy(),
           **{n: p.grad.numpy() for n, p in pm.named_parameters()}}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=1e-4 * np.abs(g).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_fuse_qkv_turns_the_kernel_routes_off(impl):
    # bf16 at head_dim 64: without the fold the sublayer route (N = 256) and
    # the ln_qkv_rope route (N = 2048) take the kernels; with it, the
    # composable route, as the JAX gates' ``not self.fuse_qkv``.
    for (h, w), route in (((16, 16), "sublayer"), ((32, 64), "ln_qkv_rope")):
        x = torch.from_numpy(_x(h, w)[:1]).permute(0, 3, 1, 2).bfloat16()
        for fuse_qkv, want in ((False, route), (True, "composable")):
            m = AttentionRoPE(C, HD, impl=impl, fuse_qkv=fuse_qkv)
            attn_mod.reset_route_counts()
            with torch.no_grad():
                m(x)
            assert attn_mod.route_counts() == {want: 1}, (h, w, fuse_qkv)


def test_fuse_qkv_refolds_after_an_in_place_update():
    # The folded operands are cached per parameter version: after an
    # in-place update of any one of the nine parameters (an optimizer
    # step) the output is a fresh module's on the new parameters.
    _, _, pm = _pair("xla", True)
    tx = torch.from_numpy(_x(8, 8)).permute(0, 3, 1, 2)
    names = [n for n, _ in pm.named_parameters() if not n.startswith("proj")]
    assert len(names) == 9
    with torch.no_grad():
        before = pm(tx)
        assert torch.equal(pm(tx), before)  # the cached fold
        for name in names:
            pm.get_parameter(name).mul_(1.1)
            fresh = AttentionRoPE(C, HD, impl="xla", fuse_qkv=True)
            fresh.load_state_dict(pm.state_dict(), strict=True)
            after = pm(tx)
            assert not torch.equal(after, before), name
            torch.testing.assert_close(after, fresh(tx), atol=0, rtol=0)
            before = after


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(2)
    yield p
    p.close()


def test_fuse_qkv_under_tensor_parallelism_matches_one_process(pool, tmp_path):
    # The micro model (2 heads at C=32, 4 at C=64) with every attention
    # module folding its QKV, 'tensor' at model 2: each rank folds its own
    # rows of each W_i. One step against one process (the bars of
    # tests/test_torch_parallel_steps.py).
    data = J.batches(1, 4)
    ref = J.train(None, 1, 1, data, steps=1, fuse_qkv=True)
    for r in pool.run(J.train, 2, tmp_path, "tensor", 2, 1, data, 1, None, None, False,
                      None, True):
        for a, b in zip(ref["metrics"], r["metrics"], strict=True):
            assert abs(a["total"] - b["total"]) <= 1e-6 * abs(a["total"]), (a, b)
        J.check_grads(ref["grads"], r["grads"])
        J.check_params(ref["grads"], ref["params"], r["params"], 1)


# -- impl='fused' ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,route", [((16, 16), "sublayer"), ((32, 64), "ln_qkv_rope")])
def test_fused_impl_matches_jax_with_the_auto_routes(hw, route, dtype):
    jm, params, pm = _pair("fused", False, dtype, *hw)
    x = _x(*hw)[:1]
    attn_mod.reset_route_counts()
    want, got = _run(jm, params, pm, x, dtype)
    fused_routes = attn_mod.route_counts()
    _close(got, want, dtype)
    auto = AttentionRoPE(C, HD, impl="auto")
    auto.load_state_dict(pm.state_dict(), strict=True)
    attn_mod.reset_route_counts()
    _, got_auto = _run(jm, params, auto, x, dtype)
    assert fused_routes == attn_mod.route_counts() == {
        route if dtype == "bfloat16" else "composable": 1}
    np.testing.assert_array_equal(got, got_auto)  # the same plain core on the CPU


def test_fused_impl_takes_the_plain_core():
    # At stage 2's N = 4096 with the kernels' conditions met, 'auto' picks
    # the flash kernel and 'fused' the plain core, as the JAX package's
    # core_attention falls through to plain XLA for 'fused'.
    assert "fused" in attn_mod.IMPLS
    assert attn_mod.core_impl(4096, "auto", True) == "pallas"
    assert attn_mod.core_impl(4096, "fused", True) == "fused"
    assert attn_mod.core_impl(1024, "fused", True) == "fused"
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal((1, 256, 2, 64))
                                .astype(np.float32)) for i in range(3))
    torch.testing.assert_close(attn_mod.core_attention(q, k, v, 0.125, "fused"),
                               attn_mod.xla_attention(q, k, v, 0.125), atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        AttentionRoPE(C, HD, impl="pallas_flash")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_fused_impl_matches_jax(dtype):
    jm, params, pm = make_pair(dtype, attention_impl="fused")
    assert pm.config.attention_impl == "fused"
    z, t, y = inputs()
    want = np.asarray(jax_forward(jm)(params, z, t, y))
    with torch.no_grad():
        got = pm(*torch_args(z, t, y)).numpy()
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= (2 ** -5 if dtype == "bfloat16" else 2e-5) * top
    _, _, xla = make_pair(dtype, attention_impl="xla")
    with torch.no_grad():
        np.testing.assert_array_equal(got, xla(*torch_args(z, t, y)).numpy())


def test_trainer_checkpoint_keeps_the_fused_impl(tmp_path):
    # Only 'auto_train' is saved as 'auto' (a training policy); 'fused'
    # stays, as the JAX trainer saves it.
    cfg = get_config(J.VARIANT, **{**J.MICRO, "attention_impl": "fused"})
    tc = TrainerConfig(batch_size=2, num_epochs=1, steps_per_epoch=1, resolution=32,
                       output_dir=str(tmp_path), weights=LossWeights(gan=0.0, lpips=0.0),
                       use_lpips=False, seed=1)
    trainer = Trainer(cfg, tc, device="cpu")
    state = trainer.create_state()
    assert all(m.impl == "fused" for m in state.model.modules() if isinstance(m, AttentionRoPE))
    trainer.save(state, epoch=0)
    assert load_config(str(tmp_path / "checkpoints")).attention_impl == "fused"
