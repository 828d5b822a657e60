"""Context parallelism at heights whose maps the context size does not
divide, and tensor parallelism that cuts attention heads, on up to 8 gloo
ranks against the JAX package on the CPU (rank jobs:
tests/torch_context_jobs.py, one pool of 8 rank processes for the file).

The model is tests/test_parallel.py's micro model (3 stages, f = 4: C=16,
16, 32, 2 heads of 16 at stage 2), DC paths on, on the port's seeded
weights. Every map is split by GSPMD's rule for an uneven shard
(``parallel.context.row_split``):

- H = 40 over context 4 (data 2): 10 rows a rank, then 5, then 3 / 3 / 3 / 1
  at stage 2 (the ring over chunks of 30, 30, 30 and 10 tokens); LPIPS's
  pooled maps down to 2 / 2 / 1 / 0 rows.
- H = 24 over context 8 (data 1): 3 rows a rank, then 2 / ... / 2 / 0 / 0,
  then 1 / ... / 1 / 0 / 0: two ranks hold no rows at stages 1 and 2.

Against the JAX model on a (data, context) mesh of 8 virtual devices
(``context_batch_sharding``, GSPMD's padding): the no-grad forward within
1e-4, and one stage-1 step with LPIPS on a random VGG (``optax.sgd``, the
JAX step's own noise handed in) within JAX's bars: loss 1e-5, parameters
5e-3 / 1e-5 (tests/test_parallel.py). The plain pieces on unequal and
empty shares: the ring against the whole map's core, the convolutions,
resamplers, pool and GroupNorm against the whole map's sliced, the halo
exchange's adjoint. The refusals kept: H % C (``shard_rows``, JAX's
``device_put``) and H % f.

Tensor parallelism at model 4, where the head count (2 at C=32) is not a
multiple of the model axis: one stage-1 step against the JAX step on a
model-4 mesh with the ``tensor`` placement (loss and grad norm 1e-4,
parameters 5e-3 / 1e-5, every gradient against JAX's within 1e-3 of the
largest), and a checkpoint written at model 4 restored at model 1 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_context_jobs as C
import torch_parallel_jobs as J
from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses.lpips import init_lpips_params as jax_init_lpips
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.parallel import context_batch_sharding
from deepl_project_tpu.parallel import create_mesh as jax_create_mesh
from deepl_project_tpu.parallel import shard_params as jax_shard_params
from deepl_project_tpu.training import init_train_state, make_train_step
from deepl_project_tpu.utils.convert import params_to_torch_state_dict, torch_state_dict_to_params
from deepl_project_tpu_torch.utils.convert import lpips_params_from_jax

torch.set_num_threads(1)
KW = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), use_dc_path=True)
# (height, data, context)
CELLS = [(40, 2, 4), (24, 1, 8)]
WEIGHTS = dict(l1=1.0, lpips=1.0, kl=1e-2)
LR = 1e-2
BATCH = 2


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(8)
    yield p
    p.close()


def _images(height: int) -> np.ndarray:
    return np.random.default_rng(height).random((BATCH, height, height, 3), np.float32)


def _pair(model_kw: dict):
    """(port state dict as numpy, JAX model, JAX params) of the model built
    from the port's seeded init; the JAX model with ``context_axis``."""
    kw = {**KW, **model_kw}
    sd = {k: v.numpy() for k, v in J.build_model(**kw).state_dict().items()}
    cfg = jax_get_config(J.VARIANT, **{**J.MICRO, **kw})
    return sd, JaxTransVAE(cfg), torch_state_dict_to_params(sd, cfg)


def _jax_mesh(data: int, context: int = 1, model: int = 1):
    return jax_create_mesh(data=data, context=context, model=model,
                           devices=jax.devices()[:data * context * model])


@pytest.fixture(scope="module")
def jax_forwards():
    """The JAX model's context forward at each cell: (state, recon, mu)."""
    sd, jm, params = _pair({"context_axis": "context"})
    fwd = jax.jit(lambda p, x: jm.apply({"params": p}, x, sample=False))
    out = {}
    for height, data, context in CELLS:
        mesh = _jax_mesh(data, context)
        with jax.set_mesh(mesh):
            recon, mu, _ = fwd(params, jax.device_put(_images(height),
                                                      context_batch_sharding(mesh)))
        out[height] = (np.asarray(recon), np.asarray(mu))
    return sd, out


def _jax_step(height: int, mesh, mode: str | None, model_kw: dict, lpips: bool):
    """The JAX step (``optax.sgd``) on ``mesh``: the model's own input
    placement under context (``context_batch_sharding``), the parameters
    placed by ``mode`` under tensor parallelism. Returns the port state, the
    loss, the grad norm, the updated parameters (port layout), the latent
    noise the step drew and the LPIPS params."""
    sd, jm, params = _pair(model_kw)
    lp = jax_init_lpips(jax.random.PRNGKey(4)) if lpips else None
    tx = optax.sgd(LR)
    w = JaxLossWeights(vf=0.0, gan=0.0, **(WEIGHTS if lpips else {**WEIGHTS, "lpips": 0.0}))
    step = make_train_step(jm, tx, w, lpips_params=lp, donate=False)
    rng = jax.random.PRNGKey(11)
    x = _images(height)
    placed = {"model": params}
    with jax.set_mesh(mesh):
        if mode is not None:
            placed = jax_shard_params(mesh, placed, mode)
        xd = (jax.device_put(x, context_batch_sharding(mesh))
              if model_kw.get("context_axis") else x)
        state, metrics = step(init_train_state(placed, tx), xd, rng)
    side = height // 4
    zero = jnp.zeros((BATCH, side, side, 4))
    noise = [np.asarray(jm.apply({"params": params}, zero, zero,
                                 rngs={"sample": jax.random.fold_in(rng, 0)},
                                 method=JaxTransVAE.reparameterize)).transpose(0, 3, 1, 2)]
    new = params_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params["model"]), None)
    lp_np = (None if lp is None else
             {g: {n: t.numpy() for n, t in leaves.items()}
              for g, leaves in lpips_params_from_jax(lp).items()})
    return (sd, float(metrics["total"]), float(metrics["grad_norm"]), new, noise, lp_np)


@pytest.fixture(scope="module")
def jax_context_steps():
    return {h: _jax_step(h, _jax_mesh(d, c), None, {"context_axis": "context"}, True)
            for h, d, c in CELLS}


@pytest.mark.parametrize("height,data,context", CELLS)
def test_forward_matches_jax_context_forward(pool, tmp_path, jax_forwards, height, data,
                                             context):
    sd, want = jax_forwards
    recon, mu = want[height]
    got = pool.run(C.forward, data * context, tmp_path, data, context, _images(height), KW,
                   sd)[0]
    np.testing.assert_allclose(got["recon"].permute(0, 2, 3, 1).numpy(), recon,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["mu"].permute(0, 2, 3, 1).numpy(), mu, rtol=1e-4, atol=1e-4)
    # Both attention sublayers (encoder and decoder stage 2) took the ring.
    assert got["routes"] == {"ring": 2}


@pytest.mark.parametrize("height,data,context", CELLS)
def test_lpips_step_matches_jax_context_step(pool, tmp_path, jax_context_steps, height, data,
                                             context):
    sd, loss, _, params, noise, lpips = jax_context_steps[height]
    for got in pool.run(C.step, data * context, tmp_path, data, context, 1, 1, _images(height),
                        noise, WEIGHTS, KW, sd, lpips, LR):
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for name, want in params.items():
            np.testing.assert_allclose(got["params"][name].numpy(), want, rtol=5e-3, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("world,tokens", [(3, 40), (4, 10), (4, 7), (8, 12)])
def test_ring_over_unequal_chunks_matches_the_whole_core(pool, tmp_path, world, tokens):
    """Chunks by the row split: 14 / 14 / 12 of 40, 3 / 3 / 3 / 1 of 10, 2 / 2 /
    2 / 1 of 7, and 2 x 6 then two empty of 12; output and gradients against
    the single-process plain core, fp32."""
    from deepl_project_tpu_torch.ops.attention import xla_attention

    rng = np.random.default_rng(tokens)
    q, k, v, do = (rng.standard_normal((2, tokens, 2, 16)).astype(np.float32)
                   for _ in range(4))
    scale = 16 ** -0.5
    whole = [torch.as_tensor(t).requires_grad_(True) for t in (q, k, v)]
    want = xla_attention(*whole, scale)
    grads = torch.autograd.grad(want, whole, torch.as_tensor(do))
    want = want.detach()
    got = pool.run(C.ring, world, tmp_path, q, k, v, do, scale, "float32")[0]
    top = float(want.abs().max())
    assert float((got["out"] - want).abs().max()) <= 2e-5 * top
    assert float((got["ref"] - want).abs().max()) <= 2e-5 * top
    for g, w in zip(got["grads"], grads):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert got["steps"] == {"forward": world, "backward": world}


@pytest.mark.parametrize("world,height", [(4, 10), (4, 5), (8, 12), (3, 14)])
def test_convs_on_unequal_rows_equal_the_whole_map_sliced(pool, tmp_path, world, height):
    """Every conv form, both resamplers and the pool on maps whose rows
    split unevenly (10 over 4: 3 / 3 / 3 / 1; 5 over 4: 2 / 2 / 1 / 0; 12
    over 8: two empty ranks) against the whole map's op sliced, with input
    gradients (fp32, 1e-5 of the largest)."""
    rng = np.random.default_rng(height)
    x = rng.standard_normal((2, 4, 2 * height, 6)).astype(np.float32)
    up_x = rng.standard_normal((2, 4, height, 6)).astype(np.float32)
    for r in pool.run(C.convs, world, tmp_path, x, up_x, 5):
        for name, (err, top, gerr, gtop) in r.items():
            assert err <= 1e-5 * top and gerr <= 1e-5 * gtop, (name, err, top, gerr, gtop)


@pytest.mark.parametrize("world,height", [(4, 10), (8, 6)])
def test_group_norm_and_rope_on_unequal_rows(pool, tmp_path, world, height):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 8, height, 4)) * 3 + 1).astype(np.float32)
    q = rng.standard_normal((2, height * 6, 2, 8)).astype(np.float32)
    for r in pool.run(C.norm_and_rope, world, tmp_path, x, q):
        assert r["norm"] <= 1e-5 and r["norm_grad"] <= 1e-5 and r["rope"] == 0.0, r


@pytest.mark.parametrize("world,top,bottom", [(4, 1, 1), (8, 2, 1)])
def test_halo_exchange_on_unequal_rows_is_its_backwards_adjoint(pool, tmp_path, world, top,
                                                                 bottom):
    # 10 rows over 4 (3 / 3 / 3 / 1: a rank thinner than a 2-row halo) and
    # over 8 (2 x 5, then three empty ranks).
    x = np.random.default_rng(3).standard_normal((2, 3, 10, 5))
    lhs, rhs = pool.run(C.halo_adjoint, world, tmp_path, x, top, bottom, 3)[0]
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs)), (lhs, rhs)


def test_context_keeps_the_jax_refusals(pool, tmp_path):
    for r in pool.run(C.refusals, 2, tmp_path, _images(32)):
        assert r["height"] == "accepted" and r["lpips"] == "accepted", r
        assert "downsample factor 8" in r["height_f"], r
        assert "context axis of 2 ranks" in r["height_c"], r


@pytest.fixture(scope="module")
def jax_tensor_step():
    return _jax_step(32, _jax_mesh(1, 1, 4), "tensor", {}, False)


def test_tensor_step_at_model_four_matches_jax(pool, tmp_path, jax_tensor_step):
    """Model 4 cuts stage 2's two heads: to_q/k/v hold 8 of 32 columns, proj
    8 input rows, as JAX places them; q, k and v are gathered for the core."""
    sd, loss, grad_norm, params, noise, _ = jax_tensor_step
    w = {**WEIGHTS, "lpips": 0.0}
    ranks = pool.run(C.step, 4, tmp_path, 1, 1, 4, 1, _images(32), noise, w, KW, sd, None, LR,
                     "tensor")
    for got in ranks:
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], grad_norm, rtol=1e-4)
        gmax = max(float(g.abs().max()) for g in got["grads"].values())
        for name, want in params.items():
            np.testing.assert_allclose(got["params"][name].numpy(), want, rtol=5e-3, atol=1e-5,
                                       err_msg=name)
            # JAX's gradient from its SGD update.
            jax_grad = (sd[name] - want) / LR
            err = float(np.abs(got["grads"][name].numpy() - jax_grad).max())
            assert err <= 1e-3 * gmax, (name, err, gmax)


@pytest.fixture(scope="module")
def model_four_checkpoint(pool, tmp_path_factory):
    """Trainer.fit with the tensor placement at model 4 (stage 2's heads cut):
    one whole checkpoint, and the ranks' gathered state."""
    data = J.batches(2, 2)
    tmp = tmp_path_factory.mktemp("model4")
    out = str(tmp / "run")
    return out, data, pool.run(J.fit, 4, tmp, "tensor", 4, out, data)[0]


def _same_state(got: dict, ranks: dict) -> None:
    assert got["step"] == ranks["step"] == 2
    for key in ("params", "ema"):
        for k, v in ranks[key].items():
            assert torch.equal(v, got[key][k]), (key, k)
    for k, v in ranks["optimizer"]["mu"].items():
        assert torch.equal(v, got["optimizer"]["mu"][k]), k


def test_checkpoint_at_model_four_restores_in_one_process(model_four_checkpoint):
    """Parameters, EMA and optimizer moments equal the model-4 ranks' gathered
    state, bit for bit."""
    out, data, ranks = model_four_checkpoint
    _same_state(J.fit("replicate", 1, out, data, resume_only=True), ranks)


def test_checkpoint_at_model_four_restores_at_model_two(pool, tmp_path, model_four_checkpoint):
    out, data, ranks = model_four_checkpoint
    for got in pool.run(J.fit, 2, tmp_path, "tensor", 2, out, data, True):
        _same_state(got, ranks)
