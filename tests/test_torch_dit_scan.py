"""The latent DiT's stacked layout (``scan_blocks`` / ``pipeline_axis``:
``blocks.block.<path>`` [depth, ...], one-to-one with JAX's
``blocks/block/...``) and its pipeline on stack slices, against the JAX
package on the CPU (rank jobs: tests/torch_pipeline_jobs.py, one pool of
rank processes for the file; set-up: tests/dit_parity.py).

- ``DiT(scan_blocks=True)`` loads JAX's scan tree with ``strict=True`` as
  the converter gives it, stacked (no unstacking); its forward lies within
  the DiT tests' fp32 bar (2e-5 of the largest) of JAX's scan DiT and is
  bit-equal to the unrolled port on the same weights; a state_dict of either
  layout loads into either (``utils.convert.load_state_dict``).
- The rules JAX's tree gets: JAX's tensor rule (``"scan" in names``) does
  not see this tree's depth axis, so its 3-D kernels stay replicated, here
  as there; FSDP and Adafactor read the whole stacked shape
  (``jax_layout``: depth first, then [in, out]).
- The stacked pipeline's forward at pipe 2 and pipe 4 against JAX's
  pipelined DiT on a pipe mesh of its virtual CPU devices (2e-4, JAX's bar
  for its pipelined DiT), and one step at data 1 x pipe 4 against JAX's
  ``make_dit_train_step`` (tests/test_torch_pipeline.py's bars; that file
  holds the data 2 x pipe 2 step).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as FlaxTrainState
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from optax._src.factorized import _factored_dims as optax_factored_dims

import torch_parallel_jobs as J
import torch_pipeline_jobs as PJ
from deepl_project_tpu.models.dit import DiT as JaxDiT
from deepl_project_tpu.parallel import param_specs as jax_param_specs
from deepl_project_tpu.training.diffusion import make_dit_train_step as jax_make_dit_train_step
from deepl_project_tpu_torch.models import DiT
from deepl_project_tpu_torch.models.dit import stack_dit_params, unstack_dit_params
from deepl_project_tpu_torch.parallel.sharding import _fsdp_axis, _tensor_axis
from deepl_project_tpu_torch.training.optim import factored_dims, jax_layout
from deepl_project_tpu_torch.utils.convert import (dit_params_to_torch_state_dict,
                                                   load_jax_dit_params, load_state_dict)

from dit_parity import (inputs, jax_cfg, jax_forward, jax_step_draws, phase5_cfg, port_cfg,
                        random_params, torch_args)

torch.set_num_threads(2)
FP32_RTOL = 2e-5


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def scan_pair():
    jm = JaxDiT(jax_cfg(scan_blocks=True, depth=3))
    params = random_params(jm, seed=3)
    return jm, params


def test_stacked_dit_loads_the_jax_scan_tree_and_runs_what_jax_runs(scan_pair):
    jm, params = scan_pair
    sd = dit_params_to_torch_state_dict(params)
    assert "blocks" in params and not any(k.startswith("block0") for k in sd)
    assert sd["blocks.block.qkv.weight"].shape == (3, 192, 64)  # [depth, out, in]
    np.testing.assert_array_equal(sd["blocks.block.ffn_down.weight"][1],
                                  params["blocks"]["block"]["ffn_down"]["kernel"][1].T)
    pm = DiT(port_cfg(jm.config), 8)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    z, t, y = inputs()
    want = np.asarray(jax_forward(jm)(params, z, t, y))
    with torch.no_grad():
        got = pm(*torch_args(z, t, y))
    err = np.abs(got.numpy() - want).max()
    assert err <= FP32_RTOL * np.abs(want).max(), err
    # The unrolled port on the same weights (the converter unstacks): the
    # same operations, bit for bit.
    flat = DiT(port_cfg(dataclasses.replace(jm.config, scan_blocks=False)), 8)
    load_jax_dit_params(flat, params)
    with torch.no_grad():
        assert torch.equal(flat(*torch_args(z, t, y)), got)
    # Either layout into either.
    back = unstack_dit_params(pm.state_dict())
    assert set(back) == set(flat.state_dict())
    assert all(torch.equal(back[k], v) for k, v in flat.state_dict().items())
    restacked = stack_dit_params(flat.state_dict(), 3)
    assert all(torch.equal(restacked[k], v) for k, v in pm.state_dict().items())
    twin = load_state_dict(DiT(port_cfg(jm.config), 8), flat.state_dict())
    assert all(torch.equal(twin.state_dict()[k], v) for k, v in pm.state_dict().items())


def test_the_jax_rules_on_the_stacked_dit_tree(scan_pair):
    jm, params = scan_pair
    pm = DiT(port_cfg(jm.config), 8)
    specs = {}
    for mode in ("tensor", "fsdp"):
        tree = jax_param_specs(params, mode, 2, fsdp_min_size=1024)
        specs[mode] = {".".join(str(getattr(k, "key", k)) for k in path): spec
                       for path, spec in jax.tree_util.tree_flatten_with_path(
                           tree, is_leaf=lambda x: isinstance(x, P))[0]}
    for name, p in pm.named_parameters():
        axes = jax_layout(name, p.shape)
        jax_shape = tuple(p.shape[a] for a in axes)
        jname = name.replace(".weight", ".kernel") if p.dim() > 1 else name
        if name == "y_embed.embedding":
            jname = name
        want_t = [i for i, a in enumerate(specs["tensor"][jname]) if a is not None]
        assert _tensor_axis(name, jax_shape, 2) is None and not want_t, name
        want_f = [i for i, a in enumerate(specs["fsdp"][jname]) if a is not None]
        got_f = _fsdp_axis(jax_shape, 2, 1024)
        assert ([] if got_f is None else [got_f]) == want_f, name
        leaf = params
        for k in jname.split("."):
            leaf = leaf[k]
        assert np.shape(leaf) == jax_shape, name  # jax_layout is JAX's axis order
        got = factored_dims(name, p.shape)
        want = optax_factored_dims(jax_shape, True, 128)
        assert (None if got is None else (axes.index(got[0]), axes.index(got[1]))) == want, name


def _port_kw(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def jax_pipelined():
    cfg = phase5_cfg(pipeline_axis="pipe", pipeline_microbatches=4)
    model = JaxDiT(cfg)
    params = random_params(model, PJ.GRID, seed=6)
    z, t, y = PJ.dit_inputs(seed=7)
    out = {}
    for pipe in (2, 4):
        with jax.set_mesh(Mesh(np.array(jax.devices()[:pipe]), ("pipe",))):
            out[pipe] = np.asarray(jax.jit(lambda p, z, t, y: model.apply(
                {"params": p}, z, t, y))(params, z, t, y))
    return cfg, dit_params_to_torch_state_dict(params), (z, t, y), out


@pytest.mark.parametrize("pipe", [2, 4])
def test_stacked_pipeline_forward_matches_jax(pool, tmp_path, jax_pipelined, pipe):
    cfg, sd, (z, t, y), want = jax_pipelined
    assert "blocks.block.qkv.weight" in sd
    got = pool.run(PJ.dit_forward, pipe, tmp_path, _port_kw(cfg), sd, z, t, y, pipe)
    per = cfg.depth // pipe
    assert [r["slices"] for r in got] == [(s * per, (s + 1) * per) for s in range(pipe)]
    for r in got:
        np.testing.assert_allclose(r["v"].numpy(), want[pipe], rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jax_pp4_step():
    cfg = phase5_cfg(pipeline_axis="pipe", pipeline_microbatches=4)
    model = JaxDiT(cfg)
    params = random_params(model, PJ.GRID, seed=12)
    z0, _, labels = PJ.dit_inputs(seed=13)
    rng = jax.random.PRNGKey(14)
    tx = optax.adamw(1e-3)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "pipe"))
    state = FlaxTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    with jax.set_mesh(mesh):
        zs = jax.device_put(z0, NamedSharding(mesh, P("data")))
        ls = jax.device_put(labels, NamedSharding(mesh, P("data")))
        state, m = jax_make_dit_train_step(model, tx, donate=False)(state, zs, ls, rng)
    t, noise = jax_step_draws(rng, z0.shape)
    as_np = lambda tree: dit_params_to_torch_state_dict(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    grads = {k: v / 0.1 for k, v in as_np(state.opt_state[0].mu).items()}
    return (cfg, dit_params_to_torch_state_dict(params), z0, labels, t, noise,
            {k: float(v) for k, v in m.items()}, as_np(state.params), grads)


def test_stacked_pipe4_step_matches_jax(pool, tmp_path, jax_pp4_step):
    cfg, sd, z0, labels, t, noise, want_m, want_p, want_g = jax_pp4_step
    got = pool.run(PJ.dit_step, 4, tmp_path, _port_kw(cfg), sd, z0, labels, t, noise,
                   (1, 4, 1), PJ.ADAMW)
    assert [r["slices"] for r in got] == [(s, s + 1) for s in range(4)]
    for r in got:
        np.testing.assert_allclose(r["metrics"]["loss"], want_m["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], want_m["grad_norm"], rtol=1e-4)
        assert r["runs"] == {"forward": 4, "backward": 4}  # 8 rows, M = 4
        assert set(r["params"]) == set(want_p) == set(r["grads"])
        PJ.check_updated(r["params"], want_p, want_g)
        for k, g in want_g.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max(), err_msg=k)
