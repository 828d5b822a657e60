"""What the port's context parallelism adds beyond L1, KL and LPIPS: the VF
term, the self-perceptual term, the GAN step and int8 models, on 2 and 4
gloo ranks at (data, context) = (1, 2) and (2, 2), against the JAX
package's single-device results on weights carried across by the
converters (rank jobs: tests/torch_context_jobs.py, one pool of rank
processes for the file). The micro model of tests/torch_parallel_jobs.py
(fp32; a 32px image is 16 rows a rank, its 4x4 latent 2).

- A stage-1 step with the VF term (weight 1.0, so its gradient shows in
  the encoder's): the stub teacher carrying JAX's projection on a 2x2 grid
  (the latent's resize to it reads across the ranks' rows) and the eager
  ``vf_proj``, against JAX's ``make_train_step`` on the same noise. The
  JAX step's optimizer is SGD written as ``trace(0)`` then ``scale(-lr)``,
  so its state holds the gradient it applied. Loss, ``vf`` and the grad
  norm 1e-5 relative (1e-7 absolute: KL is ~5e-7); ``vf_proj``'s
  gradient 1e-5 of its largest entry, every gradient 1e-4 of the largest
  (tests/test_torch_teachers.py's bar); parameters 5e-3 / 1e-5 (JAX's
  bars, tests/test_torch_context_parallel.py).
- A stage-1 step with the self-perceptual term (a frozen random twin,
  built with ``context_axis``) against JAX's ``make_self_perceptual`` and
  ``make_train_step``, the trained model under remat 'none' and 'dots'.
  The same bars. The step's backward runs inside its context block; the
  distances alone, with their gradient by the reconstruction (over C: a
  rank's rows receive C times their share) taken after the block is left (where the frozen encoder's checkpointed recompute
  must find the context group again), against JAX's
  ``make_self_perceptual`` at tests/test_torch_self_perceptual.py's bar
  (1e-5 of the largest value and gradient entry).
- One GAN step (adaptive weight, VF, R1 with gamma 10, the disc loss floor
  at 0.5, under the untrained hinge loss, so D updates) against JAX's
  ``make_gan_train_step``, with tests/gan_step_parity.py's set-up, weights,
  batch and bars (its three-stage micro model, logvar pinned at -80, both
  optimizers clipped at 1e-8; metrics 1e-4 relative, parameters 5e-4 x
  lr); the discriminator bit-identical on every rank. (On this file's
  four-stage model and batch the 32px PatchGAN's instance norms over 3x3
  maps amplify rounding: JAX's step and JAX's own gradient of the same
  loss outside it differ by ~1e-3 in the adaptive weight.) A gather whose backward only slices would halve the GAN term's
  last-layer gradient and double ``adaptive_gan_weight``.
- Int8: ``calibrate_amax`` under context on the ranks' rows against JAX's
  on whole images (1e-4 relative, tests/test_torch_quant.py's bar); for
  each scope ``quantize_model`` under context gives JAX's int8 tree (int8
  kernels bit-equal, scales 1e-4) and reconstructs within
  tests/test_torch_quant.py's whole-model bar of JAX's int8 model: relative
  L2 1e-2, or twice the JAX model's own move under 1e-6 relative input
  noise where that is larger. Its per-layer bar (2e-4 x max plus an
  allowance per flipped activation) does not hold for a whole model: a
  flip at one site moves the next sites' inputs, and in this random micro
  model the flips cascade (one process against two ranks: 1 flipped
  activation at the first site, ~6% of the decoder's).
- ``QConv2d`` under context equals the whole map's int8 conv sliced to the
  rank's rows bit for bit (the integer product is exact, the halo of the
  float map too).

The JAX results are module fixtures, computed once: each JAX step's trace
and compile of the micro model takes 10-15 s on a CPU host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gan_step_parity as G
import torch_context_jobs as C
import torch_parallel_jobs as J
from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses import teachers as jax_teachers
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.losses.vae_loss import make_self_perceptual as jax_make_self_perceptual
from deepl_project_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from deepl_project_tpu.quantize import calibrate_amax as jax_calibrate_amax
from deepl_project_tpu.quantize import quantize_params
from deepl_project_tpu.training import init_train_state, make_train_step
from deepl_project_tpu.training.optim import make_optimizer as jax_make_optimizer
from deepl_project_tpu.training.train_step import make_gan_train_step as jax_make_gan_train_step
from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch.utils.convert import (disc_params_to_torch_state_dict,
                                                   params_to_torch_state_dict)

torch.set_num_threads(1)
MESHES = [(1, 2), (2, 2)]
DATA = np.random.default_rng(7).random((4, J.RES, J.RES, 3), np.float32)
LR = 1e-2
# The stub teacher on a 2x2 grid (the image resized to 8, patches of 4).
TEACHER = dict(feature_dim=8, patch=4, resize=8, seed=3)
STEP_WEIGHTS = {"vf": dict(l1=1.0, lpips=0.0, kl=1e-2, vf=1.0, gan=0.0),
                "perceptual": dict(l1=1.0, lpips=1.0, kl=1e-2, vf=0.0, gan=0.0)}
GAN_WEIGHTS = dict(l1=1.0, lpips=0.0, kl=1e-2, vf=0.1, gan=0.1)
GAN_OPTS = dict(adaptive_weight=True, adaptive_max=1e4, r1_gamma=10.0, disc_loss_floor=0.5)
# gan_step_parity's micro model over this file's: three stages.
GAN_MODEL = {k: G.MICRO[k] for k in ("depths", "base_dims", "logvar_clip")}


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(model_kw: dict, seed: int = J.SEED):
    """(port state dict as numpy, JAX model, JAX params) of the micro model
    from the port's seeded init."""
    sd = {k: v.numpy() for k, v in J.build_model(seed, **model_kw).state_dict().items()}
    cfg = jax_get_config(J.VARIANT, **{**J.MICRO, **model_kw})
    return sd, JaxTransVAE(cfg), torch_state_dict_to_params(sd, cfg)


def _teacher():
    """(JAX stub teacher, the port's arguments carrying JAX's projection)."""
    fan = TEACHER["patch"] ** 2 * 3
    proj = jax.random.normal(jax.random.PRNGKey(TEACHER["seed"]),
                             (fan, TEACHER["feature_dim"]), jnp.float32) / jnp.sqrt(fan)
    return jax_teachers.make_stub_teacher(**TEACHER), {**TEACHER, "proj": np.asarray(proj)}


def _vf_proj():
    rng = np.random.default_rng(17)
    return {"kernel": (rng.standard_normal((4, 8)) / 2).astype(np.float32),
            "bias": (rng.standard_normal(8) / 10).astype(np.float32)}


def _jax_stage1(term: str) -> dict:
    """JAX's ``make_train_step`` on the port's seeded weights with the VF
    or the self-perceptual term: its metrics, the gradient it applied and
    the updated parameters (port names), the noise it drew, and what the
    port's job needs to build the same term."""
    sd, jm, params = _pair({})
    tree, kw, extra = {"model": params}, {}, {}
    if term == "vf":
        jteacher, extra["teacher"] = _teacher()
        extra["vf"] = _vf_proj()
        tree["vf_proj"] = dict(extra["vf"])
        kw["teacher_fn"] = jteacher
    else:
        fsd, fjm, fparams = _pair({}, seed=2)
        kw["perceptual_fn"] = jax_make_self_perceptual(fjm, fparams)
        extra["perceptual"] = {"model_kw": {}, "state": fsd}
    tx = optax.chain(optax.trace(decay=0.0), optax.scale(-LR))
    step = make_train_step(jm, tx, JaxLossWeights(**STEP_WEIGHTS[term]), donate=False, **kw)
    rng = jax.random.PRNGKey(11)
    state, metrics = step(init_train_state(tree, tx), DATA, rng)
    # The noise the step's forward drew: the model's reparameterize of
    # mu = logvar = 0 with the step's key.
    zero = jnp.zeros((DATA.shape[0], J.RES // 8, J.RES // 8, 4))
    noise = np.asarray(jm.apply({"params": params}, zero, zero,
                                rngs={"sample": jax.random.fold_in(rng, 0)},
                                method=JaxTransVAE.reparameterize)).transpose(0, 3, 1, 2)

    def port_names(t):
        out = jax_to_sd(_np(t["model"]), None)
        out.update({f"vf_proj.{k}": np.asarray(v) for k, v in t.get("vf_proj", {}).items()})
        return out

    return dict(sd=sd, noise=noise, extra=extra, metrics={k: float(v) for k, v in metrics.items()},
                grads=port_names(state.opt_state[0].trace), params=port_names(state.params))


@pytest.fixture(scope="module")
def jax_stage1():
    return {term: _jax_stage1(term) for term in STEP_WEIGHTS}


def _check_stage1(got: dict, want: dict, keys) -> None:
    for k in keys:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    top = max(np.abs(g).max() for g in want["grads"].values())
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=0, atol=1e-4 * top, err_msg=name)
    for name, p in want["params"].items():
        np.testing.assert_allclose(got["params"][name], p, rtol=5e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("data,context", MESHES)
def test_vf_step_matches_jax_make_train_step(pool, tmp_path, jax_stage1, data, context):
    want = jax_stage1["vf"]
    assert want["metrics"]["vf"] > 0
    ex = want["extra"]
    for got in pool.run(C.term_step, data * context, tmp_path, data, context, DATA,
                        want["noise"], STEP_WEIGHTS["vf"], {}, want["sd"], ex["vf"],
                        ex["teacher"], None, LR):
        _check_stage1(got, want, ("total", "l1", "kl", "vf"))
        k = want["grads"]["vf_proj.kernel"]
        np.testing.assert_allclose(got["grads"]["vf_proj.kernel"], k, rtol=0,
                                   atol=1e-5 * np.abs(k).max())


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("data,context", MESHES)
def test_self_perceptual_step_matches_jax_make_train_step(pool, tmp_path, jax_stage1,
                                                          data, context, remat):
    want = jax_stage1["perceptual"]
    assert want["metrics"]["lpips"] > 0
    model_kw = {"remat": True, "remat_policy": remat}
    for got in pool.run(C.term_step, data * context, tmp_path, data, context, DATA,
                        want["noise"], STEP_WEIGHTS["perceptual"], model_kw, want["sd"], None,
                        None, want["extra"]["perceptual"], LR):
        _check_stage1(got, want, ("total", "l1", "kl", "lpips"))


@pytest.fixture(scope="module")
def jax_perceptual():
    """JAX's self-perceptual distances of two batches and their gradient by
    the first, from the frozen twin's weights."""
    fsd, fjm, fparams = _pair({}, seed=2)
    recon, target = (np.random.default_rng(s).random(DATA.shape, np.float32) for s in (21, 22))
    jfn = jax_make_self_perceptual(fjm, fparams)

    def total(r):
        d = jfn(r, target)
        return d.sum(), d

    (_, d), g = jax.jit(jax.value_and_grad(total, has_aux=True))(recon)
    return dict(state=fsd, recon=recon.transpose(0, 3, 1, 2), target=target.transpose(0, 3, 1, 2),
                distances=np.asarray(d), grad=np.asarray(g).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("data,context", MESHES)
def test_self_perceptual_distances_and_backward_outside_the_block(pool, tmp_path,
                                                                  jax_perceptual, data, context):
    want = jax_perceptual
    for got in pool.run(C.perceptual_distance, data * context, tmp_path, data, context,
                        want["recon"], want["target"], {}, want["state"]):
        # A rank's rows receive C times their share of each distance's
        # gradient (global_mean's backward passes it through; the steps'
        # average over the parameter peers divides C out).
        d, g = got["distances"].numpy(), got["grad"].numpy() / context
        np.testing.assert_allclose(d, want["distances"], rtol=0,
                                   atol=1e-5 * np.abs(want["distances"]).max())
        np.testing.assert_allclose(g, want["grad"], rtol=0, atol=1e-5 * np.abs(want["grad"]).max())


def _jax_gan(weights: dict = GAN_WEIGHTS, opts: dict = GAN_OPTS) -> dict:
    """JAX's GAN step on tests/gan_step_parity.py's shared weights (its
    three-stage micro model with logvar pinned, its PatchGAN) and first
    batch, with the stub teacher and the VF projection; the states it
    started from (port layout), its metrics and updated parameters."""
    shared = G.make_shared()
    jteacher, teacher = _teacher()
    vf = _vf_proj()
    gen_tx = jax_make_optimizer(G.LR, 0, max_grad_norm=G.CLIP)
    disc_tx = jax_make_optimizer(G.LR, 0, max_grad_norm=G.CLIP)
    step = jax_make_gan_train_step(shared["model"], shared["disc"], gen_tx, disc_tx,
                                   JaxLossWeights(**weights), teacher_fn=jteacher, **opts)
    gstate = init_train_state({"model": shared["params"], "vf_proj": dict(vf)}, gen_tx)
    dstate = init_train_state({"model": shared["dparams"]}, disc_tx)
    batch = shared["batches"][0]
    gstate, dstate, metrics = step(gstate, dstate, jnp.asarray(batch), jax.random.PRNGKey(0))
    new = jax_to_sd(_np(gstate.params["model"]), None)
    new.update({f"vf_proj.{k}": np.asarray(v) for k, v in gstate.params["vf_proj"].items()})
    return dict(sd=jax_to_sd(_np(shared["params"]), None), vf=vf, teacher=teacher, batch=batch,
                disc=disc_params_to_torch_state_dict(_np(shared["dparams"])),
                metrics={k: float(v) for k, v in metrics.items()}, params=new,
                disc_params=disc_params_to_torch_state_dict(_np(dstate.params["model"])))


@pytest.fixture(scope="module")
def jax_gan():
    return _jax_gan()


@pytest.mark.parametrize("data,context", MESHES)
def test_gan_step_matches_jax_make_gan_train_step(pool, tmp_path, jax_gan, data, context):
    want = jax_gan
    assert want["metrics"]["disc_update_scale"] == 1.0 and want["metrics"]["vf"] > 0
    ranks = pool.run(C.gan_step, data * context, tmp_path, data, context, want["batch"],
                     want["sd"], want["vf"], want["disc"], want["teacher"], GAN_MODEL,
                     GAN_WEIGHTS, GAN_OPTS, G.LR, G.CLIP)
    worst = {}
    for got in ranks:
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            G._check(worst, "metric", got["metrics"][k], v, k)
        for n, p in want["params"].items():
            G._check(worst, "param", got["params"][n], p, n)
        for n, p in want["disc_params"].items():
            G._check(worst, "param", got["disc"][n], p, f"D {n}")
        for n, p in got["disc"].items():
            np.testing.assert_array_equal(p, ranks[0]["disc"][n], err_msg=n)


# -- int8 ------------------------------------------------------------------------
CALIB = [np.random.default_rng(s).random((2, J.RES, J.RES, 3), np.float32) for s in (1, 2)]


def _site_name(path):
    """JAX amax path (encoder, stage2_block0, ffn) -> 'encoder.stages.2.0.ffn'."""
    out = []
    for p in path:
        if p.startswith("stage") and "_block" in p:
            out += ["stages", *p[5:].split("_block")]
        else:
            out.append(p)
    return ".".join(out)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_int8():
    """JAX's whole-image calibration of the port's seeded micro model, and
    for each scope its int8 tree, its reconstruction of DATA and that
    reconstruction's own move under 1e-6 relative input noise."""
    sd, _, params = _pair({})
    cfg = jax_get_config(J.VARIANT, **J.MICRO)
    amax = jax_calibrate_amax(cfg, params, CALIB)
    want = {}
    for path, v in jax.tree_util.tree_leaves_with_path(amax):
        keys = [k.key for k in path]
        want.setdefault(_site_name(keys[:-1]), {})[keys[-1]] = float(v)
    noise = np.random.default_rng(9).standard_normal(DATA.shape).astype(np.float32)
    scopes = {}
    for scope in ("all", "resblock", "ffn"):
        qparams = _np(quantize_params(params, amax, scope=scope))
        qm = JaxTransVAE(cfg.replace(quant="int8", quant_scope=scope))
        fwd = jax.jit(lambda p, x, qm=qm: qm.apply({"params": p}, x, sample=False)[0])
        ref = np.asarray(fwd(qparams, DATA))
        floor = _rel_l2(np.asarray(fwd(qparams, DATA * (1 + 1e-6 * noise))), ref)
        scopes[scope] = dict(state=params_to_torch_state_dict(qparams), recon=ref, floor=floor)
    return dict(sd=sd, amax=want, scopes=scopes)


@pytest.mark.parametrize("data,context", MESHES)
def test_int8_calibration_under_context_matches_jax_whole_images(pool, tmp_path, jax_int8,
                                                                 data, context):
    want = jax_int8["amax"]
    for got in pool.run(C.int8, data * context, tmp_path, data, context, CALIB, DATA, {},
                        jax_int8["sd"], ()):
        assert set(got["amax"]) == set(want)
        for name, sites in want.items():
            assert set(got["amax"][name]) == set(sites), name
            for site, v in sites.items():
                np.testing.assert_allclose(got["amax"][name][site], v, rtol=1e-4,
                                           err_msg=name + site)


@pytest.mark.parametrize("scope", ["all", "resblock", "ffn"])
@pytest.mark.parametrize("data,context", MESHES)
def test_int8_forward_under_context_matches_jax_quantize_model(pool, tmp_path, jax_int8,
                                                               data, context, scope):
    want = jax_int8["scopes"][scope]
    got = pool.run(C.int8, data * context, tmp_path, data, context, CALIB, DATA, {},
                   jax_int8["sd"], (scope,))[0]["scopes"][scope]
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        assert got["state"][k].dtype == v.dtype and got["state"][k].shape == v.shape, k
        if v.dtype == np.int8:
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-4, atol=0, err_msg=k)
    err = _rel_l2(got["recon"].permute(0, 2, 3, 1).numpy(), want["recon"])
    assert err < max(1e-2, 2 * want["floor"]), (err, want["floor"])


@pytest.mark.parametrize("kernel", [3, 1])
@pytest.mark.parametrize("world", [2, 4])
def test_int8_conv_under_context_equals_the_whole_map_sliced(pool, tmp_path, world, kernel):
    x = np.random.default_rng(12).standard_normal((2, 16, 16, 12)).astype(np.float32)
    for r in pool.run(C.qconv_rows, world, tmp_path, x, kernel, 5):
        assert r["equal"] and r["err"] == 0.0, r
        assert r["shape"] == (2, 8, 16 // world, 12)
