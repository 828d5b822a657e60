"""The scan layout (``scan_blocks``) under FSDP, tensor and context
parallelism on gloo CPU ranks, against the JAX package's scan model on its
virtual CPU mesh and against the port's unrolled model under the same
placement (rank jobs: tests/torch_scan_jobs.py, tests/torch_parallel_jobs.py,
tests/torch_context_jobs.py, tests/torch_serving_jobs.py; one pool of rank
processes for the file).

The micro model of tests/torch_parallel_jobs.py with two blocks a stage
(every stack of depth 2), fp32:

- ``param_specs`` of the scan model under 'fsdp' and 'tensor' at model 2
  and 4 against JAX's ``param_specs`` on its scan tree, through the
  converter's key map (tests/test_torch_parallel.py's encoding): equal for
  every parameter (attention whose heads the axis does not divide is split
  as JAX splits it), and a stack's depth axis is never split under
  'tensor'.
- The stage-1 loss and grad norm (the latent's mean) at model 2 and data 2
  x model 2 under each mode against JAX's on its (2, 2) mesh: 1e-5
  relative, on test_torch_scan_blocks.py's model, where that bar holds
  (torch_scan_jobs.JAX_MODEL says why not the four-stage one).
- Two AdamW steps of the scan model against the unrolled model under the
  same placement: loss 1e-6 relative, gradients and parameters
  tests/torch_parallel_jobs.py's bars; three Adafactor steps (the clip
  active) against the single-process scan model (a stack's block-RMS clip
  covers the whole stack, summed over the model group).
- A BlockStack whose FSDP axis is its depth axis: a rank holds some of the
  slices and the forward gathers the stack whole once.
- A scan checkpoint written under FSDP restores into an unrolled model and
  into a replicated scan model, and ``cli.serve``'s engine serves it on a
  model-2 mesh under 'tensor' and 'fsdp'; ``cli.train --scan_blocks
  --param_sharding tensor`` trains under a launcher.
- The context-parallel scan forward and stage-1 step at (data, context) =
  (1, 2) against JAX's scan model (tests/test_torch_context_parallel.py's
  bars: 1e-4; loss 1e-5, parameters 5e-3 / 1e-5).

The JAX results are module fixtures, computed once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_context_jobs as C
import torch_parallel_jobs as J
import torch_scan_jobs as S
import torch_serving_jobs as SJ
from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.losses.vae_loss import transvae_loss as jax_transvae_loss
from deepl_project_tpu.models.transvae import init_params
from deepl_project_tpu.ops.stack import to_scanned_params as jax_to_scanned
from deepl_project_tpu.parallel import param_specs as jax_param_specs
from deepl_project_tpu.parallel import shard_params as jax_shard_params
from deepl_project_tpu.training import init_train_state, make_train_step
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch.models import TransVAE
from deepl_project_tpu_torch.ops.stack import from_scanned_params
from deepl_project_tpu_torch.parallel import Shard, param_specs
from deepl_project_tpu_torch.training.checkpoint import restore_model_params
from deepl_project_tpu_torch.utils.convert import load_state_dict, params_to_torch_state_dict

from test_torch_parallel import _axis, _encode

torch.set_num_threads(1)
DATA = J.batches(3, 4)
BATCH = DATA[0]
ADAFACTOR = {"optimizer": "adafactor", "max_grad_norm": 0.05}
MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


def _jax_cfg(**kw):
    return jax_get_config(J.VARIANT, **{**J.MICRO, **S.UNROLLED, **kw})


def _port_cfg(**kw):
    return J.micro_config(**{**S.UNROLLED, **kw})


@pytest.fixture(scope="module")
def weights():
    """(the port's seeded scan state_dict, JAX's scan tree of it)."""
    sd = {k: v.numpy() for k, v in J.build_model(**S.SCAN).state_dict().items()}
    flat = torch_state_dict_to_params(from_scanned_params(sd, _port_cfg()), _jax_cfg())
    cfg = _jax_cfg(scan_blocks=True)
    return sd, jax.tree_util.tree_map(np.asarray, jax.jit(lambda t: jax_to_scanned(t, cfg))(flat))


# -- placements ----------------------------------------------------------------
@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_scan_param_specs_match_jax(mode, size):
    jm = JaxTransVAE(_jax_cfg(scan_blocks=True))
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0), image_size=J.RES))
    specs = jax_param_specs(shapes, mode, size, fsdp_min_size=J.FSDP_MIN)
    encoded = jax.tree_util.tree_map(lambda s, p: _encode(s.shape, p), shapes, specs)
    want = {k: _axis(v) for k, v in params_to_torch_state_dict(encoded).items()}
    with torch.device("meta"):
        model = TransVAE(_port_cfg(scan_blocks=True))
    got = {k: s.dim if isinstance(s, Shard) else None
           for k, s in param_specs(model, mode, size, J.FSDP_MIN).items()}
    assert set(got) == set(want) and any(".scan.block." in k for k in got)
    # Every parameter as JAX places it, also where the tensor rule cuts a head.
    assert {k for k in got if got[k] != want[k]} == set()
    assert any(v is not None for k, v in got.items() if ".scan.block." in k)
    if mode == "tensor":  # the depth axis is never split
        assert all(v != 0 for k, v in got.items() if ".scan.block." in k)


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's scan model's stage-1 loss and grad norm (mean decoded) on the
    batch, its parameters placed under each mode on a (data 2, model 2)
    virtual CPU mesh; the model: ``torch_scan_jobs.jax_model``'s weights."""
    from deepl_project_tpu.parallel import batch_sharding, create_mesh

    port = S.jax_model()
    kw = {k: v for k, v in S.JAX_MODEL.items() if k != "scan_blocks"}
    flat = {k: v.numpy() for k, v in from_scanned_params(
        port.state_dict(), port.config).items()}
    cfg = jax_get_config(S.JAX_VARIANT, **kw)
    scan_cfg = jax_get_config(S.JAX_VARIANT, **S.JAX_MODEL)
    tree = jax.jit(lambda t: jax_to_scanned(t, scan_cfg))(torch_state_dict_to_params(flat, cfg))
    jm = JaxTransVAE(scan_cfg)
    w = JaxLossWeights(**{"l1": 1.0, "lpips": 0.0, "vf": 0.0, "gan": 0.0, "kl": 1e-2})

    def loss_fn(p, x):
        recon, mu, logvar = jm.apply({"params": p}, x, sample=False)
        return jax_transvae_loss(recon, x, mu, logvar, w)["total"]

    mesh = create_mesh(data=2, model=2, devices=jax.devices()[:4])
    out = {}
    for mode in ("fsdp", "tensor"):
        with jax.set_mesh(mesh):
            p = jax_shard_params(mesh, tree, mode, fsdp_min_size=J.FSDP_MIN)
            x = jax.device_put(BATCH, batch_sharding(mesh))
            loss, g = jax.jit(jax.value_and_grad(loss_fn))(p, x)
        out[mode] = (float(loss), float(optax.global_norm(g)))
    return out


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_scan_placed_grads_match_jax(pool, tmp_path, jax_grads, mode, data, model):
    loss, norm = jax_grads[mode]
    for r in pool.run(S.grads, data * model, tmp_path, mode, model, BATCH):
        assert any(".scan.block." in n for n in r["split"])
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-5)


def _unrolled(d: dict) -> dict:
    return from_scanned_params(d, _port_cfg())


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_scan_placed_steps_match_the_unrolled_placement(pool, tmp_path, mode, data, model):
    """Two AdamW steps (the latent sampled) of the scan model and of the
    unrolled one, each under ``mode`` on the same mesh."""
    accum = data
    args = (mode, model, accum, DATA, 2, None, None, False)
    scan = pool.run(J.train, data * model, tmp_path, *args, S.SCAN)
    flat = pool.run(J.train, data * model, tmp_path, *args, S.UNROLLED)
    ref = flat[0]
    for r in scan:
        for a, b in zip(ref["metrics"], r["metrics"], strict=True):
            assert abs(a["total"] - b["total"]) <= 1e-6 * abs(a["total"]), (a, b)
        J.check_grads(ref["grads"], _unrolled(r["grads"]))
        J.check_params(ref["grads"], ref["params"], _unrolled(r["params"]), 2)


@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_scan_adafactor_clips_a_split_stack_as_one_block(pool, tmp_path, mode):
    """Three Adafactor steps (max_grad_norm 0.05: the clip active) under
    ``mode`` at model 2 against the single-process scan model."""
    ref = J.train_reference(1, DATA, steps=3, opt=ADAFACTOR, model_kw=S.SCAN)
    assert all(m["grad_norm"] > 0.05 for m in ref["metrics"])
    for r in pool.run(J.train, 2, tmp_path, mode, 2, 1, DATA, 3, None, ADAFACTOR, False,
                      S.SCAN):
        for a, b in zip(ref["metrics"], r["metrics"], strict=True):
            assert abs(a["total"] - b["total"]) <= 1e-6 * abs(a["total"]), (a, b)
        J.check_grads(ref["grads"], r["grads"])
        J.check_params(ref["grads"], ref["params"], r["params"], 3)


def test_fsdp_split_on_the_depth_axis(pool, tmp_path):
    one = S.stack_split_on_depth(False)
    got = pool.run(S.stack_split_on_depth, 2, tmp_path, True)
    for r in got:
        assert r["dim"] == 0 and r["held"] == (4, 4, 2)  # half the slices
        assert r["gathers"] == 1  # the whole stack, once a forward
        assert torch.equal(r["y"], one["y"])
    torch.testing.assert_close(torch.cat([r["grad"] for r in got]), one["grad"],
                               rtol=0, atol=1e-6)


# -- checkpoints, serving and the CLI --------------------------------------------
def test_sharded_scan_checkpoint_restores_unrolled_and_replicated(pool, tmp_path):
    out = str(tmp_path / "run")
    got = pool.run(S.fit, 2, tmp_path, "fsdp", 2, out, DATA[:2], S.SCAN)
    whole = got[0]["params"]
    assert got[0]["step"] == 2 and any(".scan.block." in k for k in whole)
    saved = restore_model_params(f"{out}/checkpoints", prefer_ema=False)
    assert set(saved) == set(whole)  # whole stacks
    for k, v in whole.items():
        assert torch.equal(saved[k], v), k
    unrolled = load_state_dict(TransVAE(_port_cfg()), saved)
    for k, v in _unrolled(whole).items():
        assert torch.equal(unrolled.state_dict()[k], v), k
    # The Trainer restores it replicated, in either layout.
    for kw, want in ((S.SCAN, whole), (S.UNROLLED, _unrolled(whole))):
        r = S.resume("replicate", 1, out, kw)
        assert r["step"] == 2 and set(r["params"]) == set(want)
        assert all(torch.equal(r["params"][k], v) for k, v in want.items())


@pytest.mark.parametrize("mode", ["tensor", "fsdp"])
def test_serve_cli_serves_a_scan_checkpoint_on_a_mesh(pool, tmp_path, mode):
    """A scan checkpoint (``.pt`` with its config) served by cli.serve's
    engine on a model-2 mesh: the reconstruct equals one process's."""
    from deepl_project_tpu_torch import create_transvae
    from deepl_project_tpu_torch.cli import serve as serve_cli

    model = create_transvae(SJ.VARIANT, device="cpu", seed=3, scan_blocks=True, **SJ.MICRO)
    path = str(tmp_path / "scan.pt")
    torch.save({"model_state_dict": model.state_dict(),
                "config": {"variant": SJ.VARIANT, "scan_blocks": True, **SJ.MICRO}}, path)
    argv = ["--checkpoint", path, "--device", "cpu", "--max_batch", "8", "--mesh_model", "2",
            "--mesh_sharding", mode]
    x = np.random.default_rng(4).random((2, 16, 16, 3), np.float32)
    want = serve_cli.build_engine(serve_cli.build_parser().parse_args(argv[:-4])).run(
        "reconstruct", x)
    ranks = pool.run(SJ.cli_engine, 2, tmp_path, argv, x)
    assert [r["mode"] for r in ranks] == [mode] * 2 and all(r["split"] > 0 for r in ranks)
    np.testing.assert_allclose(ranks[0]["reconstruct"], want, atol=1e-6, rtol=1e-5)


def test_train_cli_scan_blocks_under_tensor_parallelism(pool, tmp_path):
    out = tmp_path / "run"
    argv = ["--data", "shapes", "--resolution", "32", "--batch_size", "2",
            "--steps_per_epoch", "2", "--num_epochs", "1", "--output_dir", str(out),
            "--device", "cpu", "--lpips_weight", "0", "--log_every", "1",
            "--scan_blocks", "--param_sharding", "tensor", "--mesh_model", "2"]
    assert pool.run(J.train_cli, 2, tmp_path, argv, 2) == [True, True]
    saved = restore_model_params(str(out / "checkpoints"))
    assert any(".scan.block." in k for k in saved)


# -- context parallelism -----------------------------------------------------------
@pytest.fixture(scope="module")
def jax_context(weights):
    """JAX's scan model's no-grad forward, and its make_train_step (optax
    sgd, two microbatches) with the latent noise each microbatch drew."""
    sd, tree = weights
    jm = JaxTransVAE(_jax_cfg(scan_blocks=True))
    x = np.random.default_rng(7).random((4, J.RES, J.RES, 3), np.float32)
    recon, mu, _ = jax.jit(lambda p, x: jm.apply({"params": p}, x, sample=False))(tree, x)
    tx = optax.sgd(1e-2)
    w = JaxLossWeights(vf=0.0, gan=0.0, l1=1.0, lpips=0.0, kl=1e-2)
    step = make_train_step(jm, tx, w, accum_steps=2, donate=False)
    rng = jax.random.PRNGKey(11)
    state, metrics = step(init_train_state({"model": tree}, tx), x, rng)
    keys = list(jax.random.split(jax.random.fold_in(rng, 0), 2))
    zero = jnp.zeros((2, J.RES // 8, J.RES // 8, 4))
    noise = [np.asarray(jm.apply({"params": tree}, zero, zero, rngs={"sample": k},
                                 method=JaxTransVAE.reparameterize)).transpose(0, 3, 1, 2)
             for k in keys]
    new = params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            state.params["model"]))
    return x, np.asarray(recon), np.asarray(mu), float(metrics["total"]), noise, new


def test_scan_context_forward_matches_jax(pool, tmp_path, weights, jax_context):
    sd = weights[0]
    x, recon, mu = jax_context[:3]
    got = pool.run(C.forward, 2, tmp_path, 1, 2, x, S.SCAN, sd)[0]
    np.testing.assert_allclose(got["recon"].permute(0, 2, 3, 1).numpy(), recon,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["mu"].permute(0, 2, 3, 1).numpy(), mu, rtol=1e-4, atol=1e-4)
    assert got["routes"] == {"ring": 8}  # two blocks in each transformer stage


def test_scan_context_step_matches_jax(pool, tmp_path, weights, jax_context):
    sd = weights[0]
    x, _, _, loss, noise, params = jax_context
    w = {"l1": 1.0, "lpips": 0.0, "kl": 1e-2}
    remat = {"remat": True, "remat_policy": "dots"}
    for got in pool.run(C.step, 2, tmp_path, 1, 2, 1, 2, x, noise, w, {**S.SCAN, **remat},
                        sd, None, 1e-2):
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert set(got["params"]) == set(params)
        for name, want in params.items():
            np.testing.assert_allclose(got["params"][name].numpy(), want, rtol=5e-3, atol=1e-5,
                                       err_msg=name)


def test_scan_stack_templates_run_their_local_shards(pool, tmp_path):
    """Under 'tensor' every attention, FFN and ResBlock template inside a
    stack is handed the model group and runs its local-shard forward on
    each slice: the no-grad forward at attention 'auto' takes the local
    heads route for each of the 8 sublayers and equals the unrolled
    model's under the same placement (1e-6 of the largest: the same sums)."""
    scan = pool.run(S.forward_tensor, 2, tmp_path, 2, BATCH, S.SCAN)
    flat = pool.run(S.forward_tensor, 2, tmp_path, 2, BATCH, S.UNROLLED)
    # 12 templates: a ResBlock, or an attention and a ConvFFN, a stage; the
    # unrolled model's 24 modules, two a stage.
    assert [r["grouped"] for r in flat] == [24, 24]
    for r in scan:
        assert r["routes"] == {"local_heads": 8} and r["grouped"] == 12
        for key in ("recon", "mu"):
            err = float((r[key] - flat[0][key]).abs().max())
            assert err <= 1e-6 * float(flat[0][key].abs().max()), (key, err)
