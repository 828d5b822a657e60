"""The port's Switch-MoE expert parallelism (``ops/moe.py`` under an
ambient expert group) and the latent DiT's pipeline x expert step on gloo
CPU ranks, against the JAX package and the single-process port (rank jobs:
tests/torch_pipeline_jobs.py, one pool of rank processes for the file).

- ``SwitchFFN`` over an expert group of 2 and of 4 (2 and 1 of 4 experts a
  rank), capacity drops forced, against the JAX module's output: 1e-5 x
  max (tests/test_moe.py's bar); its load-balance loss 1e-6 relative; the
  gradients of x, the router and every expert (gathered) against the
  single-process port's, 1e-5 x max.
- One DiT step (the dry run's phase-5 model with 4 experts) on a
  (data, pipe, expert) = (1, 2, 2) mesh, and with experts only on (2, 1,
  2), against the same step on one process: loss and grad norm 1e-4
  relative, every gradient 1e-4 of its largest, the updated parameters as
  tests/test_torch_pipeline.py holds them, the optimizer's whole state 1e-4
  of its largest; under AdamW and (on (1, 2, 2)) Adafactor, whose factored
  and RMS means sum over the expert group. On (1, 2, 2) the JAX step on the
  same mesh gives the same loss (1e-4), and neither package reports
  ``moe_aux`` or ``total``: JAX's pipelined layout drops the router loss,
  and the port mirrors it. On (2, 1, 2) (no pipeline) the router loss is
  the global batch's, as one process's.
- The router loss is dropped under ``pipeline_axis`` in both packages.
- bf16 on (1, 2, 2): the no-grad forward 2^-6 of max, the step's loss 1e-3
  and grad norm 1e-2 from one process's (the card's bars).
- The dry run's phase 5 at 4 ranks on (1, 2, 2): the JAX gate needs 8
  ranks, and 8 gloo processes exceed a test's budget here; the card runs
  ``python -m deepl_project_tpu_torch.parallel.dryrun --nproc 8``.
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
from deepl_project_tpu.ops.moe import SwitchFFN as JaxSwitchFFN
from deepl_project_tpu.ops.moe import collect_aux_losses as jax_collect_aux_losses
from deepl_project_tpu.training.diffusion import make_dit_train_step as jax_make_dit_train_step
from deepl_project_tpu.training.diffusion import rectified_flow_loss as jax_rf_loss
from deepl_project_tpu_torch.ops.moe import SwitchFFN
from deepl_project_tpu_torch.utils.convert import dit_params_to_torch_state_dict

from dit_parity import jax_step_draws, phase5_cfg, random_params

torch.set_num_threads(1)
B, N, D, H, E = 2, 16, 32, 64, 4


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("expert", [2, 4])
def test_torch_switch_ffn_expert_parallel_matches_jax(pool, tmp_path, expert):
    jm = JaxSwitchFFN(d=D, hidden=H, num_experts=E, capacity_factor=0.5, use_swiglu=True,
                      expert_axis=None, dtype=jnp.float32, param_dtype=jnp.float32)
    rng = np.random.default_rng(expert)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x)["params"])
    want, aux_vars = jm.apply({"params": params}, x, mutable=["losses"])
    want = np.asarray(want)
    sd = dit_params_to_torch_state_dict(params)
    got = pool.run(PJ.switch_ffn, expert, tmp_path, sd, x, E, 0.5, g)
    assert [r["world"] for r in got] == [expert] * expert
    assert [r["held"] for r in got] == [(r * E // expert, (r + 1) * E // expert)
                                        for r in range(expert)]
    # The single-process port's gradients.
    one = SwitchFFN(D, H, E, 0.5, True, None)
    one.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    xt = torch.tensor(x, requires_grad=True)
    params_t = dict(one.named_parameters())
    ref = torch.autograd.grad((one(xt) * torch.from_numpy(g)).sum(),
                              [xt] + list(params_t.values()))
    assert np.all(want == 0.0, axis=-1).sum() >= 8  # capacity drops happen
    for r in got:
        assert np.abs(r["out"].numpy() - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(r["aux"], float(jax_collect_aux_losses(aux_vars)),
                                   rtol=1e-6)
        for got_g, want_g in zip([r["dx"]] + [r["grads"][n] for n in params_t], ref):
            assert (got_g - want_g).abs().max() <= 1e-5 * want_g.abs().max()


def _cfg(**kw):
    return phase5_cfg(moe_experts=4, **kw)


PIPE = dict(pipeline_axis="pipe", pipeline_microbatches=2)


@pytest.fixture(scope="module")
def jax_pipe_expert_step():
    """JAX's phase-5 step on a (1, 2, 2) mesh: (cfg, weights, batch, t, noise,
    metrics)."""
    cfg = _cfg(**PIPE)
    model = JaxDiT(cfg)
    params = random_params(model, PJ.GRID, seed=4)
    z0, _, labels = PJ.dit_inputs(seed=5)
    rng = jax.random.PRNGKey(6)
    tx = optax.adamw(1e-3)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2), ("data", "pipe", "expert"))
    state = FlaxTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    with jax.set_mesh(mesh):
        zs = jax.device_put(z0, NamedSharding(mesh, P("data")))
        ls = jax.device_put(labels, NamedSharding(mesh, P("data")))
        _, m = jax_make_dit_train_step(model, tx, donate=False)(state, zs, ls, rng)
    t, noise = jax_step_draws(rng, z0.shape)
    return (cfg, dit_params_to_torch_state_dict(params), z0, labels, t, noise,
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("mesh,pipelined,opt", [((1, 2, 2), True, "adamw"),
                                                ((2, 1, 2), False, "adamw"),
                                                ((1, 2, 2), True, "adafactor")])
def test_torch_pipe_expert_step_matches_one_process(pool, tmp_path, jax_pipe_expert_step,
                                                    mesh, pipelined, opt):
    cfg, sd, z0, labels, t, noise, jax_m = jax_pipe_expert_step
    if not pipelined:
        cfg = dataclasses.replace(cfg, pipeline_axis=None)
    kw = dataclasses.asdict(cfg)
    opt_kw = PJ.ADAMW if opt == "adamw" else dict(learning_rate=1e-3, warmup_steps=0,
                                                optimizer="adafactor")
    one = PJ.dit_step(kw, sd, z0, labels, t, noise, None, opt_kw)
    got = pool.run(PJ.dit_step, 4, tmp_path, kw, sd, z0, labels, t, noise, mesh, opt_kw)
    assert [r["world"] for r in got] == [4] * 4
    keys = {"loss", "v_norm", "grad_norm"} | (set() if pipelined else {"moe_aux", "total"})
    assert set(one["metrics"]) == keys
    if pipelined:  # JAX drops the router loss on the same mesh
        assert set(jax_m) == keys
        np.testing.assert_allclose(one["metrics"]["loss"], jax_m["loss"], rtol=1e-4)
    grads = {k: v.numpy() for k, v in one["grads"].items()}
    for r in got:
        assert set(r["metrics"]) == keys
        for k in keys:
            np.testing.assert_allclose(r["metrics"][k], one["metrics"][k], rtol=1e-4,
                                       err_msg=k)
        assert r["runs"] == ({"forward": 2, "backward": 2} if pipelined else {})
        assert set(r["params"]) == set(one["params"]) == set(r["grads"])
        PJ.check_updated(r["params"], {k: v.numpy() for k, v in one["params"].items()}, grads)
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g, rtol=1e-4,
                                       atol=1e-4 * np.abs(g).max(), err_msg=k)
        # The optimizer's state, whole (a checkpoint's), as one process's.
        assert r["opt"].keys() == one["opt"].keys()
        for key, named in one["opt"].items():
            assert named.keys() == r["opt"][key].keys()
            for k, v in named.items():
                top = float(v.abs().max())
                assert float((r["opt"][key][k] - v).abs().max()) <= 1e-4 * top + 1e-30, (key, k)
    # Two experts of four a rank; under the pipeline two slices of the stack
    # a stage (its experts' axis is 1).
    up = "moe_ffn.experts.up.weight"
    for r in got:
        if pipelined:
            assert r["slices"] == ((0, 2), (2, 4))[r is got[2] or r is got[3]]
            assert r["held"][f"blocks.block.{up}"][:2] == (2, 2)
            continue
        held = {n.split(".")[0] for n in r["held"] if n.startswith("block")}
        assert r["slices"] is None and len(held) == 4
        assert all(r["held"][f"{b}.{up}"][0] == 2 for b in held)


@pytest.mark.parametrize("kw", [PIPE, {}, {"scan_blocks": True}],
                         ids=["pipeline_axis", "none", "scan_blocks"])
def test_torch_moe_aux_dropped_under_the_pipeline_in_both_packages(kw):
    """JAX's pipelined DiT (a 2-device pipe mesh) reports no router loss;
    nor does the port's config with ``pipeline_axis``, nor either package's
    with ``scan_blocks`` (the stacked layout: ``nn.scan`` carries only the
    params); without them both report 'moe_aux' and 'total'."""
    from deepl_project_tpu_torch.models import DiT, DiTConfig
    from deepl_project_tpu_torch.training import rectified_flow_loss

    z0, _, labels = PJ.dit_inputs(seed=7)
    cfg = _cfg(**kw)
    jm = JaxDiT(cfg)
    params = random_params(jm, PJ.GRID, seed=8)
    fn = jax.jit(lambda p, z, y: jax_rf_loss(jm, p, z, y, jax.random.PRNGKey(9))[1])
    if kw:
        with jax.set_mesh(Mesh(np.array(jax.devices()[:2]), ("pipe",))):
            jax_keys = set(fn(params, z0, labels))
    else:
        jax_keys = set(fn(params, z0, labels))
    pm = DiT(DiTConfig(**dataclasses.asdict(cfg)), PJ.GRID)
    pm.load_state_dict({k: torch.from_numpy(v)
                        for k, v in dit_params_to_torch_state_dict(params).items()})
    _, m = rectified_flow_loss(pm, torch.from_numpy(z0), torch.from_numpy(labels).long(),
                               torch.Generator().manual_seed(0))
    want = {"loss", "v_norm"} | (set() if kw else {"moe_aux", "total"})
    assert jax_keys == set(m) == want


def test_torch_dryrun_phase5_at_four_ranks(pool, tmp_path):
    got = pool.run(PJ.dryrun_phase5, 4, tmp_path, 1, 2, 2)
    assert [r["world"] for r in got] == [4] * 4
    for r in got:
        assert r["mesh"] == {"data": 1, "pipe": 2, "expert": 2}
        assert abs(r["loss"] - r["sequential_loss"]) <= 1e-4 * max(1.0, abs(r["sequential_loss"]))
        assert abs(r["grad_norm"] - r["sequential_grad_norm"]) <= 1e-4 * max(
            1.0, r["sequential_grad_norm"])
        assert r["keys"] == ["grad_norm", "loss", "v_norm"]


def test_torch_bf16_pipe_expert_dit_matches_one_process(pool, tmp_path):
    """bf16 (the card's dtype; gloo carries bf16 transfers, broadcasts and
    all-gathers) on (1, 2, 2): the no-grad forward within 2^-6 of the
    largest of one process's (two bf16 steps), the step's loss within 1e-3
    and grad norm within 1e-2 (the card's bars, chip_smoke.py)."""
    cfg = dataclasses.replace(_cfg(**PIPE), dtype="bfloat16")
    params = random_params(JaxDiT(cfg), PJ.GRID, seed=10)
    sd = dit_params_to_torch_state_dict(params)
    z, t, y = PJ.dit_inputs(seed=11)
    kw = dataclasses.asdict(cfg)
    one = PJ.bf16_forward(kw, sd, z, t, y, None)
    got = pool.run(PJ.bf16_forward, 4, tmp_path, kw, sd, z, t, y, (1, 2, 2))
    assert [r["world"] for r in got] == [4] * 4
    top = one["v"].abs().max()
    for r in got:
        assert (r["v"] - one["v"]).abs().max() <= 2 ** -6 * top
        assert abs(r["loss"] - one["loss"]) <= 1e-3 * abs(one["loss"])
        assert abs(r["grad_norm"] - one["grad_norm"]) <= 1e-2 * one["grad_norm"]
