"""The port's training losses against the JAX package's, on the CPU.

Same seeded numpy inputs on both sides (NHWC for JAX, NCHW for the port) and
the same LPIPS weights: a tree of the JAX ``init_lpips_params`` structure, taken to the
port's layout by ``utils.convert.lpips_params_from_jax``. Images are 32 px.

Tolerances: fp32 throughout; 1e-5 relative on the elementwise terms (L1,
KL, GAN), 1e-4 relative on LPIPS and the total (a 13-conv VGG trunk whose
sums run in other orders).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from deepl_project_tpu.losses import vae_loss as jloss
from deepl_project_tpu_torch.losses import vae_loss as tloss
from deepl_project_tpu_torch.utils.convert import lpips_params_from_jax

# The packages export a function named lpips, which hides the module.
jlpips = importlib.import_module("deepl_project_tpu.losses.lpips")
tlpips = importlib.import_module("deepl_project_tpu_torch.losses.lpips")

torch.set_num_threads(2)


def _jax_lpips_tree(seed=3):
    """Random params of the JAX LPIPS tree's structure and distributions,
    drawn with numpy (quicker than eager jax.random on the CPU)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jlpips.init_lpips_params)
    tree = {"conv": {}, "lin": {}}
    for name, s in shapes["conv"].items():
        if name.startswith("w"):
            fan_in = 9 * s.shape[2]
            tree["conv"][name] = (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        else:
            tree["conv"][name] = (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    for name, s in shapes["lin"].items():
        tree["lin"][name] = (np.abs(rng.standard_normal(s.shape)) / s.shape[0]).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def lpips_pair():
    jp = _jax_lpips_tree()
    return jp, lpips_params_from_jax(jp)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _inputs(seed, b=2, res=32, d=4):
    rng = np.random.default_rng(seed)
    f = np.float32
    logits = (2 * rng.standard_normal((b, res, res, 3))).astype(f)
    target = rng.random((b, res, res, 3), dtype=f)
    mu = (3 * rng.standard_normal((b, res // 16, res // 16, d))).astype(f)
    logvar = (20 * rng.standard_normal((b, res // 16, res // 16, d))).astype(f)  # clamps
    return logits, target, mu, logvar


def test_l1_and_kl_match_jax():
    logits, target, mu, logvar = _inputs(0)
    img = 1 / (1 + np.exp(-logits))
    np.testing.assert_allclose(float(tloss.l1_loss(_nchw(img), _nchw(target))),
                               float(jloss.l1_loss(img, target)), rtol=1e-5)
    np.testing.assert_allclose(float(tloss.kl_divergence(_nchw(mu), _nchw(logvar))),
                               float(jloss.kl_divergence(mu, logvar)), rtol=1e-5)


def test_lpips_matches_jax(lpips_pair):
    jp, tp = lpips_pair
    rng = np.random.default_rng(1)
    x = (2 * rng.random((2, 32, 32, 3), dtype=np.float32) - 1)
    y = (2 * rng.random((2, 32, 32, 3), dtype=np.float32) - 1)
    want = np.asarray(jlpips.lpips(jp, x, y))
    got = tlpips.lpips(tp, _nchw(x), _nchw(y))
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert float(tlpips.lpips(tp, _nchw(x), _nchw(x)).abs().max()) == 0.0


def test_lpips_params_structure_and_file(tmp_path, lpips_pair):
    _, tp = lpips_pair
    fresh = tlpips.init_lpips_params(torch.Generator().manual_seed(0))
    for group in ("conv", "lin"):
        assert set(fresh[group]) == set(tp[group])
        for name, t in tp[group].items():
            assert fresh[group][name].shape == t.shape
    assert all((t >= 0).all() for t in fresh["lin"].values())
    # The .npz schema (HWIO conv kernels) loads to the same params.
    jp = _jax_lpips_tree()
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **{f"{g}/{n}": np.asarray(v) for g, leaves in jp.items()
                      for n, v in leaves.items()})
    assert tlpips.lpips_params_available(str(path))
    assert not tlpips.lpips_params_available(str(tmp_path / "missing.npz"))
    loaded = tlpips.load_lpips_params(str(path))
    for group in ("conv", "lin"):
        for name, t in tp[group].items():
            torch.testing.assert_close(loaded[group][name], t, rtol=0, atol=0)


@pytest.mark.parametrize("with_lpips", [False, True])
def test_transvae_loss_matches_jax(lpips_pair, with_lpips):
    jp, tp = lpips_pair
    logits, target, mu, logvar = _inputs(2)
    w = jloss.LossWeights(l1=1.0, lpips=0.5, kl=1e-3)
    want = jloss.transvae_loss(logits, target, mu, logvar, w,
                               lpips_params=jp if with_lpips else None)
    got = tloss.transvae_loss(_nchw(logits), _nchw(target), _nchw(mu), _nchw(logvar),
                              tloss.LossWeights(l1=1.0, lpips=0.5, kl=1e-3),
                              lpips_params=tp if with_lpips else None)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == ()
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7)
    if not with_lpips:
        assert float(got["lpips"]) == 0.0


def test_vf_and_gan_terms_match_jax():
    rng = np.random.default_rng(3)
    f = np.float32
    lat = rng.standard_normal((2, 4, 4, 8)).astype(f)
    dino = rng.standard_normal((2, 4, 4, 16)).astype(f)
    kern = rng.standard_normal((8, 16)).astype(f)
    bias = rng.standard_normal(16).astype(f)
    want = jloss.vf_loss(lat, dino, kern, bias, margin=2.0)
    got = tloss.vf_loss(_nchw(lat), _nchw(dino), torch.from_numpy(kern),
                        torch.from_numpy(bias), margin=2.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    real, fake = rng.standard_normal((2, 5)).astype(f), rng.standard_normal((2, 5)).astype(f)
    np.testing.assert_allclose(float(tloss.gan_generator_loss(torch.from_numpy(fake))),
                               float(jloss.gan_generator_loss(fake)), rtol=1e-5)
    for kind in ("bce", "hinge", "wgan"):
        np.testing.assert_allclose(
            float(tloss.discriminator_loss(torch.from_numpy(real), torch.from_numpy(fake), kind)),
            float(jloss.discriminator_loss(real, fake, kind)), rtol=1e-5)
    with pytest.raises(ValueError):
        tloss.discriminator_loss(torch.zeros(1), torch.zeros(1), "lsgan")


def test_psnr_ssim_match_jax():
    from deepl_project_tpu.utils import metrics as jmetrics
    from deepl_project_tpu_torch.utils import metrics as tmetrics

    rng = np.random.default_rng(4)
    x = rng.random((2, 24, 24, 3), dtype=np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape).astype(np.float32), 0, 1)
    y[1, :12] = 0.5  # flat windows: the clamped variance estimate
    for name in ("psnr", "ssim"):
        want = np.asarray(getattr(jmetrics, name)(x, y))
        got = getattr(tmetrics, name)(_nchw(x), _nchw(y))
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
