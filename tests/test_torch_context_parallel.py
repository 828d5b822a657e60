"""The port's context parallelism on the micro model, on 2 and 4 gloo ranks,
against the JAX package's single-device results on converted weights and
against the single-process port (rank jobs: tests/torch_context_jobs.py,
one pool of rank processes for the file).

- The forward (``context_axis='context'`` under ``context_parallel``, each
  rank its rows of each image, DC paths on) at context 2, context 4 and
  data 2 x context 2 against the JAX model's single-device forward: 1e-4
  (JAX's bar, tests/test_parallel.py).
- One stage-1 step (the latent sampled, JAX's noise handed in: the JAX
  step's ``fold_in(rng, step)``, split per microbatch, drawn by the model's
  own ``reparameterize``), L1 + KL as JAX's test and then with LPIPS on a
  random VGG, at context 2 and at data 2 x context 2, both with two
  microbatches, against the JAX package's ``make_train_step`` with
  ``optax.sgd``: loss 1e-5, parameters 5e-3 / 1e-5 (JAX's bars).
- Context 2 x model 2 (tensor parallelism) and remat 'none' under context
  against the single-process port (gradients and parameters 1e-5 of the
  largest).
- What it accepts and refuses: the VF term, the self-perceptual term, the
  GAN step, an int8 model run (tests/test_torch_context_terms.py holds
  them to the JAX package), a height whose maps split unevenly and LPIPS on
  8 rows a rank (tests/test_torch_context_heights.py holds such heights to
  the JAX package); a height the downsample factor or the context size
  does not divide (JAX's refusals) and a model without ``context_axis``
  under an ambient context group raise.
- ``python -m deepl_project_tpu_torch.parallel.dryrun``'s phases on 4 ranks.

The JAX results are module fixtures, computed once: the JAX step's trace
and compile of the micro model takes 10-15 s on a CPU host, more than a
test's 8 s.
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
from deepl_project_tpu.training import init_train_state, make_train_step
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch.utils.convert import lpips_params_from_jax

torch.set_num_threads(1)
DC = {"use_dc_path": True}
DATA = np.random.default_rng(7).random((4, J.RES, J.RES, 3), np.float32)


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


def _pair(model_kw: dict):
    """(port state dict as numpy, JAX model, JAX params) of the micro model
    built from the port's seeded init."""
    sd = {k: v.numpy() for k, v in J.build_model(**model_kw).state_dict().items()}
    cfg = jax_get_config(J.VARIANT, **{**J.MICRO, **model_kw})
    return sd, JaxTransVAE(cfg), torch_state_dict_to_params(sd, cfg)


@pytest.fixture(scope="module")
def jax_forward():
    sd, jm, params = _pair(DC)
    recon, mu, _ = jax.jit(lambda p, x: jm.apply({"params": p}, x, sample=False))(params, DATA)
    return sd, np.asarray(recon), np.asarray(mu)


@pytest.mark.parametrize("data,context", [(1, 2), (1, 4), (2, 2)])
def test_forward_matches_jax_single_device(pool, tmp_path, jax_forward, data, context):
    sd, recon, mu = jax_forward
    got = pool.run(C.forward, data * context, tmp_path, data, context, DATA, DC, sd)[0]
    np.testing.assert_allclose(got["recon"].permute(0, 2, 3, 1).numpy(), recon,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["mu"].permute(0, 2, 3, 1).numpy(), mu, rtol=1e-4, atol=1e-4)
    # Every attention sublayer (2 encoder, 2 decoder) took the ring.
    assert got["routes"] == {"ring": 4}


WEIGHTS = {"l1_kl": dict(l1=1.0, lpips=0.0, kl=1e-2), "lpips": dict(l1=1.0, lpips=1.0, kl=1e-2)}
LR = 1e-2
ACCUM = 2


def _jax_step(terms: str, accum: int):
    """The JAX step's loss and updated params (port layout, numpy), the
    latent noise it drew per microbatch, and the LPIPS params, on the
    port's seeded weights."""
    from deepl_project_tpu.utils.convert import params_to_torch_state_dict

    sd, jm, params = _pair({})
    lp = jax_init_lpips(jax.random.PRNGKey(4)) if terms == "lpips" else None
    tx = optax.sgd(LR)
    step = make_train_step(jm, tx, JaxLossWeights(vf=0.0, gan=0.0, **WEIGHTS[terms]),
                           lpips_params=lp, accum_steps=accum, donate=False)
    rng = jax.random.PRNGKey(11)
    state, metrics = step(init_train_state({"model": params}, tx), DATA, rng)
    # The noise each microbatch's forward drew: the model's reparameterize
    # of mu = logvar = 0 with that microbatch's key (the JAX step's draw).
    key = jax.random.fold_in(rng, 0)
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    side = J.RES // 8
    zero = jnp.zeros((DATA.shape[0] // accum, side, side, 4))
    noise = [np.asarray(jm.apply({"params": params}, zero, zero, rngs={"sample": k},
                                 method=JaxTransVAE.reparameterize)).transpose(0, 3, 1, 2)
             for k in keys]
    new = params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            state.params["model"]), None)
    lpips = (None if lp is None else
             {g: {n: t.numpy() for n, t in leaves.items()}
              for g, leaves in lpips_params_from_jax(lp).items()})
    return sd, float(metrics["total"]), new, noise, lpips


@pytest.fixture(scope="module")
def jax_steps():
    return {terms: _jax_step(terms, ACCUM) for terms in WEIGHTS}


@pytest.mark.parametrize("terms", ["l1_kl", "lpips"])
@pytest.mark.parametrize("data,context", [(1, 2), (2, 2)])
def test_step_matches_jax_make_train_step(pool, tmp_path, jax_steps, terms, data, context):
    sd, loss, params, noise, lpips = jax_steps[terms]
    for got in pool.run(C.step, data * context, tmp_path, data, context, 1, ACCUM, DATA, noise,
                        WEIGHTS[terms], {}, sd, lpips, LR):
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for name, want in params.items():
            np.testing.assert_allclose(got["params"][name].numpy(), want, rtol=5e-3, atol=1e-5,
                                       err_msg=name)


def _against_single_process(got_ranks, ref):
    for got in got_ranks:
        assert abs(got["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
        J.check_grads(ref["grads"], got["grads"])
        gmax = max(float(v.abs().max()) for v in ref["params"].values())
        for k, v in ref["params"].items():
            assert float((v - got["params"][k]).abs().max()) <= 1e-5 * gmax, k


def test_context_by_tensor_parallel_matches_single_process(pool, tmp_path):
    """Context 2 x model 2: the ring on each rank's heads (1 of 2 at C=32,
    2 of 4 at C=64), the column convs' gathered maps exchanging halos."""
    noise = [np.random.default_rng(8).standard_normal((4, 4, 4, 4)).astype(np.float32)]
    w = WEIGHTS["lpips"]
    lp = {g: {n: t.numpy() for n, t in leaves.items()}
          for g, leaves in lpips_params_from_jax(jax_init_lpips(jax.random.PRNGKey(4))).items()}
    ref = C.step_reference(1, DATA, noise, w, {}, None, lp)
    _against_single_process(pool.run(C.step, 4, tmp_path, 1, 2, 2, 1, DATA, noise, w, {}, None,
                                     lp, LR, "tensor"), ref)


def test_remat_none_under_context_matches_single_process(pool, tmp_path):
    """Remat 'none' (the CLI's policy): each block's recompute in the
    backward runs its halo exchanges, moment sums and ring again."""
    noise = [np.random.default_rng(9).standard_normal((2, 4, 4, 4)).astype(np.float32)
             for _ in range(2)]
    remat = {"remat": True, "remat_policy": "none", "remat_resample": True}
    ref = C.step_reference(2, DATA, noise, WEIGHTS["l1_kl"], {})
    _against_single_process(pool.run(C.step, 2, tmp_path, 1, 2, 1, 2, DATA, noise,
                                     WEIGHTS["l1_kl"], remat), ref)


def test_what_context_parallelism_refuses(pool, tmp_path):
    for r in pool.run(C.refusals, 2, tmp_path, DATA):
        for accepted in ("vf", "perceptual", "gan", "int8", "height", "lpips"):
            assert r[accepted] == "accepted", r
        assert "downsample factor 8" in r["height_f"], r
        assert "context axis of 2 ranks" in r["height_c"], r
        assert "context_axis unset" in r["unset"], r


def test_dryrun_phases_on_four_ranks(pool, tmp_path):
    from deepl_project_tpu_torch.parallel import dryrun

    for r in pool.run(dryrun.run, 4, tmp_path, "cpu"):
        assert set(r["losses"]) == {"DPxTP", "DPxCPxTP", "FSDP"}, r
        assert any(line.startswith("dryrun equality OK") for line in r["lines"])


def test_dryrun_refuses_to_start_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    from deepl_project_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--nproc", "2"])
