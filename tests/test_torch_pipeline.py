"""The port's GPipe pipeline (``deepl_project_tpu_torch/parallel/pipeline.py``)
and the pipelined latent DiT on gloo CPU ranks, against the JAX package's
``pipeline_apply`` and pipelined DiT on its virtual CPU devices (rank jobs:
tests/torch_pipeline_jobs.py, one pool of rank processes for the file).

- ``pipeline_apply`` on the conditioned residual MLP stack of
  tests/test_pipeline.py: the forward at (stages, M) = (2, 4), (4, 4),
  (1, 4) within rtol/atol 2e-5 (JAX's own bar), the gradients of mean(y^2)
  at 4 stages in every block's weights, x and cond within rtol 2e-4 / atol
  2e-5; its refusals (depth % stages, batch % M) with JAX's messages.
- The DiT with ``pipeline_axis`` under a pipe group of 4 against JAX's
  pipelined DiT on a 4-device pipe mesh (random weights in every layer),
  2e-4; with no group the same config equals the sequential port exactly.
- One DiT step at data 2 x pipe 2 against JAX's ``make_dit_train_step``
  at data 2 x pipe 2 with optax's ``adamw(1e-3)`` (JAX's t and noise handed
  in): loss and grad norm rtol 1e-4, every updated parameter rtol 3e-4 /
  atol 3e-5 (tests/test_pipeline.py's bars), except an entry whose gradient
  lies within 1e-5 of its tensor's largest, which Adam's first step may
  move by a different fraction of lr (within 2 lr, the rule of
  tests/torch_parallel_jobs.check_params); every gradient the update
  sees (whole) within rtol 1e-4 / 1e-5 of the largest of JAX's (Adam's
  first moment over 1 - b1); each stage ran its 4 microbatches both ways.
- ``create_dit`` under a placement allocates only its stage's blocks (and
  experts) with the whole model's values, and a whole checkpoint round
  trips through ``full_state`` / ``load_full``; a global batch of 4 at data
  2 and M = 4 (local rows that M does not divide) runs JAX's microbatches
  and matches JAX's step and the sequential port's.

The JAX results are module fixtures: the pipelined step's trace and
compile take seconds on a CPU host.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as FlaxTrainState
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_jobs as J
import torch_pipeline_jobs as PJ
from deepl_project_tpu.models.dit import DiT as JaxDiT
from deepl_project_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from deepl_project_tpu.training.diffusion import make_dit_train_step as jax_make_dit_train_step
from deepl_project_tpu_torch.models import DiT, DiTConfig
from deepl_project_tpu_torch.utils.convert import dit_params_to_torch_state_dict, load_state_dict

from dit_parity import jax_step_draws, phase5_cfg, random_params

torch.set_num_threads(1)
DEPTH, B, N, D = 8, 8, 16, 32


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


def _mlp_data():
    rng = np.random.default_rng(0)
    params = {k: (0.1 * rng.standard_normal((DEPTH, D, D))).astype(np.float32)
              for k in ("w1", "w2")}
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    cond = rng.standard_normal((B, D)).astype(np.float32)
    return params, x, cond


def _jax_block(p, x, cond):
    return x + jnp.tanh(x @ p["w1"] + cond[:, None, :]) @ p["w2"]


def _jax_mlp(stages, micro, params, x, cond):
    mesh = Mesh(np.array(jax.devices()[:stages]), ("pipe",))
    return jax.jit(lambda p, x, c: jax_pipeline_apply(_jax_block, p, x, c, mesh=mesh,
                                                      num_microbatches=micro))


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 4), (1, 4)])
def test_torch_pipeline_apply_forward_matches_jax(pool, tmp_path, stages, micro):
    params, x, cond = _mlp_data()
    want = np.asarray(_jax_mlp(stages, micro, params, x, cond)(params, x, cond))
    got = pool.run(PJ.mlp_pipeline, stages, tmp_path, params, x, cond, micro, False)
    assert [r["world"] for r in got] == [stages] * stages
    for r in got:  # whole on every rank
        np.testing.assert_allclose(r["y"].numpy(), want, rtol=2e-5, atol=2e-5)


def test_torch_pipeline_apply_gradients_match_jax(pool, tmp_path):
    params, x, cond = _mlp_data()
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))

    def loss(p, x, c):
        return jnp.mean(jax_pipeline_apply(_jax_block, p, x, c, mesh=mesh,
                                           num_microbatches=4) ** 2)

    gp, gx, gc = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, x, cond)
    got = pool.run(PJ.mlp_pipeline, 4, tmp_path, params, x, cond, 4, True)
    assert len(got) == 4 and got[0]["world"] == 4
    seen = set()
    for r in got:
        assert r["others_zero"]
        np.testing.assert_allclose(r["dx"].numpy(), np.asarray(gx), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["dcond"].numpy(), np.asarray(gc), rtol=2e-4, atol=2e-5)
        for (i, k), g in r["blocks"].items():
            np.testing.assert_allclose(g.numpy(), np.asarray(gp[k][i]), rtol=2e-4, atol=2e-5)
            seen.add((i, k))
    assert seen == {(i, k) for i in range(DEPTH) for k in ("w1", "w2")}


def test_torch_pipeline_apply_refusals(pool, tmp_path):
    got = pool.run(PJ.refusals, 3, tmp_path)
    assert got[0]["world"] == 3
    for r in got:
        assert r["depth"] == "depth 8 not divisible by pipeline stages 3"
        assert r["batch"] == "batch 8 not divisible by num_microbatches 3"


def _port_kw(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def jax_dit_forward():
    cfg = phase5_cfg(pipeline_axis="pipe", pipeline_microbatches=4)
    model = JaxDiT(cfg)
    params = random_params(model, PJ.GRID)
    z, t, y = PJ.dit_inputs()
    with jax.set_mesh(Mesh(np.array(jax.devices()[:4]), ("pipe",))):
        out = jax.jit(lambda p, z, t, y: model.apply({"params": p}, z, t, y))(params, z, t, y)
    return cfg, dit_params_to_torch_state_dict(params), np.asarray(out)


def test_torch_pipelined_dit_forward_matches_jax(pool, tmp_path, jax_dit_forward):
    cfg, sd, want = jax_dit_forward
    z, t, y = PJ.dit_inputs()
    got = pool.run(PJ.dit_forward, 4, tmp_path, _port_kw(cfg), sd, z, t, y, 4)
    assert [r["world"] for r in got] == [4] * 4
    assert [r["slices"] for r in got] == [(s, s + 1) for s in range(4)]  # a slice a stage
    for r in got:
        np.testing.assert_allclose(r["v"].numpy(), want, rtol=2e-4, atol=2e-4)
    # No pipe group: the config's blocks run one after another, exactly the
    # sequential port's.
    args = torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y).long()
    with torch.no_grad():
        outs = []
        for kw in (_port_kw(cfg), {**_port_kw(cfg), "pipeline_axis": None}):
            m = load_state_dict(DiT(DiTConfig(**kw), PJ.GRID), sd)  # stacked, unrolled
            outs.append(m(*args))
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=2e-4, atol=2e-4)


def _jax_dp_pp(batch: int):
    """JAX's make_dit_train_step at data 2 x pipe 2, M = 4, with optax's
    adamw(1e-3), on a global batch of ``batch`` latents: the config, the
    weights, the inputs, JAX's own t and noise, its metrics, updated
    parameters and gradients (as port state_dicts)."""
    cfg = phase5_cfg(pipeline_axis="pipe", pipeline_microbatches=4)
    model = JaxDiT(cfg)
    params = random_params(model, PJ.GRID, seed=2)
    z0, _, labels = PJ.dit_inputs(b=batch, seed=3)
    rng = jax.random.PRNGKey(3)
    tx = optax.adamw(1e-3)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))
    state = FlaxTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    with jax.set_mesh(mesh):
        zs = jax.device_put(z0, NamedSharding(mesh, P("data")))
        ls = jax.device_put(labels, NamedSharding(mesh, P("data")))
        state, m = jax_make_dit_train_step(model, tx, donate=False)(state, zs, ls, rng)
    t, noise = jax_step_draws(rng, z0.shape)
    as_np = lambda tree: dit_params_to_torch_state_dict(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    # Adam's first moment after one step is (1 - b1) g: JAX's gradient.
    grads = {k: v / 0.1 for k, v in as_np(state.opt_state[0].mu).items()}
    return (cfg, dit_params_to_torch_state_dict(params), z0, labels, t, noise,
            {k: float(v) for k, v in m.items()}, as_np(state.params), grads)


@pytest.fixture(scope="module")
def jax_dp_pp_step():
    return _jax_dp_pp(8)


@pytest.fixture(scope="module")
def jax_dp_pp_step_b4():
    return _jax_dp_pp(4)


def test_torch_dp_pp_dit_step_matches_jax(pool, tmp_path, jax_dp_pp_step):
    cfg, sd, z0, labels, t, noise, want_m, want_p, want_g = jax_dp_pp_step
    got = pool.run(PJ.dit_step, 4, tmp_path, _port_kw(cfg), sd, z0, labels, t, noise,
                   (2, 2, 1), PJ.ADAMW)
    assert [r["world"] for r in got] == [4] * 4
    assert set(want_m) == {"loss", "v_norm", "grad_norm"}
    for r in got:
        assert set(r["metrics"]) == set(want_m)
        np.testing.assert_allclose(r["metrics"]["loss"], want_m["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], want_m["grad_norm"], rtol=1e-4)
        assert r["runs"] == {"forward": 4, "backward": 4}  # 4 local rows, M = 4
        assert set(r["params"]) == set(want_p) == set(r["grads"])
        PJ.check_updated(r["params"], want_p, want_g)
        for k, g in want_g.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max(), err_msg=k)
    # Each stage holds its own two slices of every stack.
    assert [r["slices"] for r in got] == [(0, 2), (2, 4), (0, 2), (2, 4)]  # rank = 2 d + p
    assert all(r["held"]["blocks.block.qkv.weight"][0] == 2 for r in got)


@pytest.mark.parametrize("mesh", [(2, 2, 1), (1, 2, 2)])
def test_torch_staged_dit_init_and_whole_checkpoint(pool, tmp_path, mesh):
    cfg = phase5_cfg(pipeline_axis="pipe", pipeline_microbatches=2, moe_experts=4)
    got = pool.run(PJ.staged_init, 4, tmp_path, _port_kw(cfg), *mesh)
    assert [r["world"] for r in got] == [4] * 4
    assert all(r["equal"] and r["full_equal"] and r["round_trip"] for r in got)
    # A stage allocates its two slices only (and two experts of four at
    # expert 2: the experts' axis of a stack is 1).
    stages = ([(0, 2), (2, 4)] * 2 if mesh == (2, 2, 1)  # rank = 2 d + p
              else [(0, 2), (0, 2), (2, 4), (2, 4)])    # rank = 2 p + e
    assert [r["slices"] for r in got] == stages
    experts = 4 // mesh[2]
    assert all(r["shapes"]["blocks.block.moe_ffn.experts.up.weight"][:2] == (2, experts)
               for r in got)


def test_torch_local_rows_refusal(pool, tmp_path, jax_dp_pp_step_b4):
    """Global batch 4 at data 2 x pipe 2 and 4 microbatches (2 rows a rank,
    which M does not divide; the port refused it before): the step runs
    JAX's microbatches, global rows [i, i + 1), each rank its two, and
    matches JAX's data x pipe step (jax_dp_pp_step's, at batch 4) and the
    sequential port (one process, no pipe group) on the same draws, at
    test_torch_dp_pp_dit_step_matches_jax's bars."""
    cfg, sd, z0, labels, t, noise, want_m, want_p, want_g = jax_dp_pp_step_b4
    args = (_port_kw(cfg), sd, z0, labels, np.array(t), np.array(noise))
    seq = PJ.dit_step(*args, None, PJ.ADAMW)
    got = pool.run(PJ.dit_step, 4, tmp_path, *args, (2, 2, 1), PJ.ADAMW)
    assert [r["world"] for r in got] == [4] * 4
    for ref in (want_m, seq["metrics"]):
        for r in got:
            np.testing.assert_allclose(r["metrics"]["loss"], ref["loss"], rtol=1e-4)
            np.testing.assert_allclose(r["metrics"]["grad_norm"], ref["grad_norm"], rtol=1e-4)
    for r in got:
        assert r["runs"] == {"forward": 2, "backward": 2}  # rows 2d, 2d + 1: 2 of the 4
        PJ.check_updated(r["params"], want_p, want_g)
        for grads in (want_g, {k: v.numpy() for k, v in seq["grads"].items()}):
            for k, g in grads.items():
                np.testing.assert_allclose(r["grads"][k].numpy(), g, rtol=1e-4,
                                           atol=1e-5 * np.abs(g).max(), err_msg=k)
