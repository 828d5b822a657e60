"""The port's VF teachers (``losses/teachers.py``) and the VF term in both
training steps, against the JAX package on the CPU.

- The resize to 224 against ``jax.image.resize(method='bilinear')``.
- The stub teacher carrying JAX's projection against JAX's
  ``make_stub_teacher``; the port's own projection is seeded (a known,
  tested deviation: ``jax.random`` cannot be drawn without JAX).
- ``make_vf_teacher`` falls back to the stub with JAX's warning where no
  DINOv2 weights are on the machine (nothing is downloaded).
- ``make_vf_proj_params``: shapes, scale and a zero bias.
- The VF term of a micro model's stage-1 loss, and of the GAN generator's
  loss, with its gradients for the model and for ``vf_proj``, against
  ``jax.value_and_grad`` of the JAX steps' loss (``_loss_and_metrics``, the
  function both JAX steps differentiate) on the same weights, teacher and
  projection. The latent noise is pinned out as in tests/gan_step_parity.py
  (logvar at -80).

Tolerances: resize 1e-6 absolute on [0, 1] images (fp32, other summation
order); stub features 1e-5 relative; losses 1e-5 relative and gradients
1e-4 x the largest gradient (the micro model's, tests/test_torch_training.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses import teachers as jax_teachers
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from deepl_project_tpu.training.train_step import _loss_and_metrics as jax_loss_and_metrics
from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.losses import teachers
from deepl_project_tpu_torch.models import PatchDiscriminator, TransVAE, init_weights
from deepl_project_tpu_torch.training import make_vf_proj_params
from deepl_project_tpu_torch.training.train_step import compute_grads, gan_generator_grads
from deepl_project_tpu_torch.utils.convert import load_jax_disc_params, load_jax_train_params

torch.set_num_threads(2)
VARIANT = "tiny_f8d16"
MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
             dtype="float32", attention_impl="auto_train", use_dc_path=False,
             logvar_clip=(-80.0, 20.0))
# A small stub teacher: 4x4 patches of the image resized to 16, 8 channels
# (the latent of a 32px image at f8 is 4x4, the teacher's grid too).
TEACHER = dict(feature_dim=8, patch=4, resize=16, seed=3)
WEIGHTS = dict(l1=1.0, lpips=0.0, kl=1e-2, vf=0.1)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _jax_stub_proj(feature_dim=768, patch=14, seed=0):
    """JAX make_stub_teacher's projection (its body's draw)."""
    fan = patch * patch * 3
    proj = jax.random.normal(jax.random.PRNGKey(seed), (fan, feature_dim), jnp.float32)
    return np.asarray(proj / jnp.sqrt(fan))


def test_resize_matches_jax_image_resize():
    x = np.random.default_rng(0).random((2, 256, 256, 3), dtype=np.float32)
    want = jax.image.resize(x, (2, 224, 224, 3), method="bilinear")
    got = teachers.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), 224)
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_stub_teacher_matches_jax_with_its_projection():
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    jfn = jax_teachers.make_stub_teacher()
    want = np.asarray(jfn(jnp.asarray(x)))  # [2, 16, 16, 768]
    fn = teachers.make_stub_teacher(proj=_jax_stub_proj())
    got = fn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert fn.feature_dim == jfn.feature_dim == 768 and tuple(got.shape) == (2, 768, 16, 16)
    assert not got.requires_grad
    _close(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # The port's own draw: seeded, the JAX stub's scale, not JAX's numbers.
    a = teachers.make_stub_teacher()(torch.from_numpy(x).permute(0, 3, 1, 2))
    b = teachers.make_stub_teacher()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(a, b) and not torch.allclose(a, got)
    assert 0.5 < float(a.std() / got.std()) < 2.0
    with pytest.raises(ValueError, match="proj must be"):
        teachers.make_stub_teacher(proj=np.zeros((3, 768), np.float32))


def test_vf_teacher_falls_back_to_the_stub_with_jax_text(capsys):
    jfn = jax_teachers.make_vf_teacher("no-such-org/no-such-dinov2")
    jax_text = capsys.readouterr().out
    fn = teachers.make_vf_teacher("no-such-org/no-such-dinov2")
    assert capsys.readouterr().out == jax_text != ""
    assert "stub teacher" in jax_text
    assert fn.feature_dim == jfn.feature_dim == 768
    assert teachers.make_dino_teacher("no-such-org/no-such-dinov2") is None
    assert teachers.make_vf_teacher("no-such-org/no-such-dinov2", allow_stub=False) is None
    assert not teachers.dinov2_available("no-such-org/no-such-dinov2")


def test_vf_proj_params_shape_and_scale():
    proj = make_vf_proj_params(32, 768, torch.Generator().manual_seed(0))
    assert tuple(proj.kernel.shape) == (32, 768) and tuple(proj.bias.shape) == (768,)
    assert not proj.bias.any() and proj.kernel.requires_grad
    assert abs(float(proj.kernel.detach().std()) * 32 ** 0.5 - 1.0) < 0.02


@pytest.fixture(scope="module")
def shared():
    """Port model, JAX model and params, the JAX stub teacher, its
    projection, vf_proj (JAX tree) and a batch of 32px images."""
    cfg = get_config(VARIANT, **MICRO)
    src = TransVAE(cfg, device="cpu")
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    sd["conv_logvar.bias"] = np.full_like(sd["conv_logvar.bias"], -200.0)
    params = torch_state_dict_to_params(sd, jax_get_config(VARIANT, **MICRO))
    rng = np.random.default_rng(7)
    vf = {"kernel": (rng.standard_normal((4, 8)) / 2).astype(np.float32),
          "bias": np.zeros(8, np.float32)}
    port = TransVAE(cfg, device="cpu")
    # The JAX trainer's {'model', 'vf_proj'} tree into the port's state.
    vf_proj = load_jax_train_params(port, {"model": params, "vf_proj": vf})
    assert torch.equal(vf_proj.kernel.detach(), torch.from_numpy(vf["kernel"]))
    assert load_jax_train_params(TransVAE(cfg, device="cpu"), {"model": params}) is None
    return dict(port=port, jm=JaxTransVAE(jax_get_config(VARIANT, **MICRO)), vf_proj=vf_proj,
                params=params, vf=vf, jteacher=jax_teachers.make_stub_teacher(**TEACHER),
                teacher=teachers.make_stub_teacher(
                    **TEACHER, proj=_jax_stub_proj(8, 4, TEACHER["seed"])),
                batch=rng.random((2, 32, 32, 3), dtype=np.float32))


@pytest.mark.parametrize("step", ["stage1", "gan"])
def test_vf_term_and_grads_match_jax_steps(shared, step):
    s = shared
    weights = dict(WEIGHTS, gan=0.1 if step == "gan" else 0.0)
    jparams = {"model": s["params"], "vf_proj": s["vf"]}
    disc_apply = disc = None
    if step == "gan":
        jd = JaxPatchDiscriminator(dtype=jnp.float32)
        shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        drng = np.random.default_rng(11)
        dparams = jax.tree_util.tree_map_with_path(
            lambda p, a: ((0.02 if p[-1].key == "kernel" else 0.1)
                          * drng.standard_normal(a.shape)
                          + (p[-1].key == "scale")).astype(np.float32), shapes["params"])
        disc = PatchDiscriminator(dtype=torch.float32, device="cpu")
        load_jax_disc_params(disc, dparams)

        def disc_apply(img):
            return jd.apply({"params": dparams}, img)

    def loss_fn(p):
        return jax_loss_and_metrics(s["jm"], p, s["batch"], jax.random.PRNGKey(0),
                                    JaxLossWeights(**weights), None, s["jteacher"],
                                    disc_apply)

    (_, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    vf_proj = s["vf_proj"]
    batch = torch.from_numpy(s["batch"])
    if step == "gan":
        grads, metrics = gan_generator_grads(
            s["port"], disc, batch, LossWeights(**weights), teacher_fn=s["teacher"],
            vf_proj=vf_proj, generator=torch.Generator().manual_seed(0))
    else:
        grads, metrics = compute_grads(s["port"], batch, LossWeights(**weights),
                                       generator=torch.Generator().manual_seed(0),
                                       teacher_fn=s["teacher"], vf_proj=vf_proj)
    assert float(jm["vf"]) > 0
    for k in ("total", "l1", "kl", "vf", "gan"):
        _close(float(metrics[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    want = jax_to_sd(jax.tree_util.tree_map(np.asarray, jgrads["model"]), None)
    want["vf_proj.kernel"] = np.asarray(jgrads["vf_proj"]["kernel"])
    want["vf_proj.bias"] = np.asarray(jgrads["vf_proj"]["bias"])
    names = [n for n, _ in s["port"].named_parameters()] + ["vf_proj.kernel", "vf_proj.bias"]
    assert len(names) == len(grads) and set(names) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    assert np.abs(want["vf_proj.kernel"]).max() > 1e-3 * top  # the VF term reaches it
    for name, g in zip(names, grads):
        _close(g.numpy(), want[name], rtol=0, atol=1e-4 * top)
