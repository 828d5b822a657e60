"""The port's rectified-flow training and sampling
(``deepl_project_tpu_torch/training/diffusion.py``) against the JAX
package's on the CPU, on the micro DiT of ``tests/dit_parity.py`` and the
micro tokenizer of ``tests/test_dit.py`` (converted weights, fp32).

The JAX functions draw t, the noise and the initial z from their own key
stream; the test derives those draws from the JAX key exactly as the JAX
functions do and hands them to the port (``t=``, ``noise=``, ``z=``).

- ``LatentStats`` (std with ddof 0) and its round trip.
- ``rectified_flow_loss``: the loss, its metrics and every gradient against
  ``jax.value_and_grad``, under logit-normal and uniform times, dense and
  with ``moe_experts=4`` (the aux loss in 'moe_aux' and 'total').
- Two ``make_dit_train_step`` steps (``make_optimizer(b2=0.95)``, EMA 0.9):
  the params, the EMA and the metrics against the JAX step and optax.
- 4 steps equal 2 steps and a resume from the saved step state (the
  generator seeded from (seed, step)), bit for bit.
- ``make_sampler`` at CFG 1 and 4 from the same initial z;
  ``generate_images`` through the micro tokenizer's decode; ``generation_fid``
  at micro scale; ``encode_to_latents``.

Tolerances (fp32, sums in other orders): the loss 1e-5 relative; each
gradient 1e-4 x its largest entry; the sampler and the images 1e-4 x the
largest value; the latents 1e-5 x the largest. After two optimizer steps
each parameter entry and its EMA within 1e-6 + 2e-3 x lr (measured 1.3e-6
at lr 1e-3: Adam divides by the gradient's root mean square, so a gradient
within rounding of zero could move its entry by up to lr; none does here).
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.training import diffusion as jd
from deepl_project_tpu.training import init_ema_train_state
from deepl_project_tpu.training.optim import make_optimizer as jax_make_optimizer
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.models import DiT, TransVAE
from deepl_project_tpu_torch.training import (LatentStats, TrainState, encode_to_latents,
                                              generate_images, generation_fid,
                                              make_dit_train_step, make_optimizer, make_sampler,
                                              rectified_flow_loss)
from deepl_project_tpu_torch.training.train_step import init_ema
from deepl_project_tpu_torch.utils.convert import dit_params_to_torch_state_dict, load_jax_params

from dit_parity import jax_cfg, make_pair, port_cfg

torch.set_num_threads(2)
LR = 1e-3
VAE_MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4, head_dim=16)


def _z0(b=4, grid=8, c=4, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, grid, grid, c)).astype(np.float32), \
        np.array([1, 3, 7, 10][:b], np.int32)


def _jax_draws(rng, shape, time_sampling="logit_normal"):
    """t and the noise as ``rectified_flow_loss`` draws them from ``rng``."""
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    if time_sampling == "logit_normal":
        t = jax.nn.sigmoid(jax.random.normal(t_rng, (shape[0],), jnp.float32))
    else:
        t = jax.random.uniform(t_rng, (shape[0],), jnp.float32)
    noise = jax.random.normal(n_rng, shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


def _close(got: torch.Tensor, want, rel: float, what: str):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rel * np.abs(want).max() + 1e-12, (what, err, np.abs(want).max())


def test_torch_latent_stats_match_jax():
    z = 3.0 + 2.0 * np.random.default_rng(0).standard_normal((16, 8, 8, 4)).astype(np.float32)
    want = jd.LatentStats.from_latents(jnp.asarray(z))
    got = LatentStats.from_latents(torch.from_numpy(z))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-5)
    zn = got.normalize(torch.from_numpy(z))
    np.testing.assert_allclose(zn.numpy(), np.asarray(want.normalize(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.denormalize(zn).numpy(), z, rtol=1e-5, atol=1e-5)
    ident = LatentStats.identity(4)
    assert torch.equal(ident.normalize(zn), zn)


@pytest.mark.parametrize("time_sampling,moe", [("logit_normal", 0), ("uniform", 0),
                                               ("logit_normal", 4)])
def test_torch_rectified_flow_loss_and_grads_match_jax(time_sampling, moe):
    jm, params, pm = make_pair(moe_experts=moe)
    z0, y = _z0()
    rng = jax.random.PRNGKey(7)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        functools.partial(jd.rectified_flow_loss, jm, time_sampling=time_sampling),
        has_aux=True))(params, z0, y, rng)
    t, noise = _jax_draws(rng, z0.shape, time_sampling)
    got_loss, got = rectified_flow_loss(pm, torch.from_numpy(z0), torch.from_numpy(y).long(),
                                        None, time_sampling, t=t, noise=noise)
    assert set(got) == set(metrics) == ({"loss", "v_norm", "moe_aux", "total"} if moe
                                        else {"loss", "v_norm"})
    for k in metrics:
        np.testing.assert_allclose(float(got[k].detach()), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    named = dict(pm.named_parameters())
    tg = dict(zip(named, torch.autograd.grad(got_loss, list(named.values()))))
    want = dit_params_to_torch_state_dict(grads)
    assert set(want) == set(tg)
    for name, g in want.items():
        _close(tg[name], g, 1e-4, name)


def _jax_steps(jm, params, z0, y, rng, n):
    tx = jax_make_optimizer(learning_rate=LR, warmup_steps=2, b2=0.95)
    state = init_ema_train_state(params, tx)
    step = jd.make_dit_train_step(jm, tx, ema_decay=0.9, donate=False)
    out = []
    for _ in range(n):
        state, m = step(state, z0, y, rng)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _port_state(pm):
    opt = make_optimizer(list(pm.named_parameters()), learning_rate=LR, warmup_steps=2,
                         b2=0.95)
    return TrainState(step=0, model=pm, optimizer=opt, ema=init_ema(pm))


def test_torch_dit_train_steps_and_ema_match_optax():
    jm, params, pm = make_pair()
    z0, y = _z0()
    rng = jax.random.PRNGKey(11)
    jstate, jmetrics = _jax_steps(jm, params, z0, y, rng, 2)
    state = _port_state(pm)
    step_fn = make_dit_train_step(pm, ema_decay=0.9)
    for s in range(2):
        t, noise = _jax_draws(jax.random.fold_in(rng, s), z0.shape)
        m = step_fn(state, torch.from_numpy(z0), torch.from_numpy(y).long(), t=t, noise=noise)
        for k in ("loss", "v_norm", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), jmetrics[s][k], rtol=1e-5, err_msg=k)
    assert state.step == 2 and state.optimizer.count == 2
    for tree, ours in ((jstate.params, dict(pm.named_parameters())),
                       (jstate.ema_params, state.ema)):
        want = dit_params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, tree))
        for name, w in want.items():
            err = np.abs(ours[name].detach().numpy() - w).max()
            assert err <= 1e-6 + 2e-3 * LR, (name, err)


def _snapshot(state) -> bytes:
    buf = io.BytesIO()
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "ema": state.ema, "step": state.step}, buf)
    return buf.getvalue()


def test_torch_dit_train_resume_equals_unbroken_run():
    """The step draws t, the noise and the label dropout from (seed, step):
    2 steps, a save and a resume into a fresh model give what 4 unbroken
    steps give, bit for bit (label dropout on)."""
    cfg = port_cfg(jax_cfg(class_dropout=0.5))
    z0, y = (torch.from_numpy(a) for a in _z0())
    y = y.long()

    def fresh():
        model = DiT(cfg, 8)
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.1)
        return _port_state(model)

    whole = fresh()
    step_fn = make_dit_train_step(whole.model, ema_decay=0.9, seed=5)
    for _ in range(4):
        step_fn(whole, z0, y)

    part = fresh()
    step_fn = make_dit_train_step(part.model, ema_decay=0.9, seed=5)
    for _ in range(2):
        step_fn(part, z0, y)
    saved = torch.load(io.BytesIO(_snapshot(part)), weights_only=True)
    resumed = fresh()
    resumed.model.load_state_dict(saved["model"])
    resumed.optimizer.load_state_dict(saved["optimizer"])
    resumed.ema, resumed.step = saved["ema"], saved["step"]
    step_fn = make_dit_train_step(resumed.model, ema_decay=0.9, seed=5)
    for _ in range(2):
        step_fn(resumed, z0, y)
    for name, p in whole.model.state_dict().items():
        assert torch.equal(p, resumed.model.state_dict()[name]), name
        assert torch.equal(whole.ema[name], resumed.ema[name]), name


@pytest.mark.parametrize("cfg_scale", [1.0, 4.0])
def test_torch_sampler_matches_jax(cfg_scale):
    jm, params, pm = make_pair()
    labels = np.array([1, 2, 10], np.int32)
    rng = jax.random.PRNGKey(3)
    want = jd.make_sampler(jm, num_steps=4, cfg_scale=cfg_scale, num_classes=10)(
        params, rng, jnp.asarray(labels), 8, 4)
    z = torch.from_numpy(np.asarray(jax.random.normal(rng, (3, 8, 8, 4), jnp.float32)))
    got = make_sampler(pm, num_steps=4, cfg_scale=cfg_scale, num_classes=10)(
        torch.from_numpy(labels).long(), 8, 4, z=z)
    assert got.shape == (3, 8, 8, 4) and got.dtype == torch.float32
    _close(got, want, 1e-4, f"cfg {cfg_scale}")


@pytest.fixture(scope="module")
def tokenizers():
    """The micro tokenizer in both packages, random weights (N(0, 0.05^2)
    leaves on the JAX tree's shapes) converted into the port."""
    jcfg = jax_get_config("tiny_f16d32", dtype="float32", attention_impl="xla").replace(
        **VAE_MICRO)
    jvae = JaxTransVAE(jcfg)
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jvae.init({"params": jax.random.PRNGKey(0),
                                               "sample": jax.random.PRNGKey(1)}, x)["params"])
    rng = np.random.default_rng(4)
    vparams = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    pvae = TransVAE(get_config("tiny_f16d32", dtype="float32", attention_impl="xla").replace(
        **VAE_MICRO))
    load_jax_params(pvae, vparams)
    return jvae, vparams, pvae.eval()


def test_torch_generate_images_matches_jax(tokenizers):
    jvae, vparams, pvae = tokenizers
    jm, params, pm = make_pair()
    mean = np.linspace(-0.5, 0.5, 4).astype(np.float32)
    std = np.linspace(0.5, 2.0, 4).astype(np.float32)
    labels = np.array([0, 5], np.int32)
    rng = jax.random.PRNGKey(9)
    gen = jax.jit(functools.partial(jd.generate_images, jvae, dit_model=jm, grid=8,
                                    num_steps=2, cfg_scale=4.0))
    want = gen(vae_params=vparams, dit_params=params,
               stats=jd.LatentStats(mean=jnp.asarray(mean), std=jnp.asarray(std)), rng=rng,
               labels=jnp.asarray(labels))
    z = torch.from_numpy(np.asarray(jax.random.normal(rng, (2, 8, 8, 4), jnp.float32)))
    got = generate_images(pvae, None, pm, None,
                          LatentStats(torch.from_numpy(mean), torch.from_numpy(std)), None,
                          torch.from_numpy(labels).long(), grid=8, num_steps=2, cfg_scale=4.0,
                          z=z)
    assert got.shape == (2, 32, 32, 3) and 0.0 <= float(got.min()) <= float(got.max()) <= 1.0
    _close(got, want, 1e-4, "images")


def test_torch_generation_fid_micro(tokenizers):
    """The FID harness at micro scale (crude pooled features): finite, >= 0,
    the same for the same generator seed, conditional and unconditional."""
    _, _, pvae = tokenizers
    _, params, pm = make_pair()

    def feature_fn(imgs):  # NCHW [B, 3, 32, 32] -> [B, 48]
        return torch.nn.functional.avg_pool2d(imgs, 8).flatten(1)

    real = [np.random.default_rng(i).random((4, 32, 32, 3), np.float32) for i in range(3)]
    fids = [generation_fid(pvae, None, pm, None, LatentStats.identity(4), iter(real),
                           feature_fn, torch.Generator().manual_seed(1), num_samples=8,
                           batch_size=4, grid=8, num_steps=2, cfg_scale=cfg,
                           unconditional=uncond)
            for cfg, uncond in ((4.0, False), (4.0, False), (1.0, True))]
    assert all(np.isfinite(f) and f >= 0.0 for f in fids), fids
    assert fids[0] == fids[1]


def test_torch_encode_to_latents_matches_jax(tokenizers):
    jvae, vparams, pvae = tokenizers
    x = np.random.default_rng(6).random((2, 32, 32, 3), np.float32)
    want = jax.jit(functools.partial(jd.encode_to_latents, jvae))(vparams, jnp.asarray(x))
    got = encode_to_latents(pvae, None, x)
    assert got.shape == (2, 8, 8, 4)  # three stages: f4
    _close(got, want, 1e-5, "mu")
    sampled = encode_to_latents(pvae, None, x, sample=True,
                                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mu, logvar = (t.permute(0, 2, 3, 1) for t in pvae.encode(
            torch.from_numpy(x).permute(0, 3, 1, 2)))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(sampled, mu + eps * torch.exp(0.5 * logvar))
