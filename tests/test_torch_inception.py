"""The port's InceptionV3 features and rFID against the JAX package's, on the
CPU.

The JAX function runs op by op (no ``jit``) on seeded random parameters
in its layout (HWIO He-normal kernels, drawn with numpy: JAX's own
``init_inception_params`` takes ~15 s op by op), which the port receives
through ``params_from_numpy`` (HWIO -> OIHW). The port's own seeded init
draws from a torch.Generator, a known deviation. Tolerance: features
within 1e-4 x their largest magnitude (fp32 through 94 convolutions summed
in other orders; measured ~1.3e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu.utils import inception as jinc
from deepl_project_tpu.utils.inception_spec import conv_specs as jax_conv_specs
from deepl_project_tpu_torch import evaluation as ev
from deepl_project_tpu_torch.utils import fid
from deepl_project_tpu_torch.utils import inception as inc
from deepl_project_tpu_torch.utils import inception_spec

torch.set_num_threads(2)
RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same as the port's tensors)."""
    rng = np.random.default_rng(3)
    raw = {}
    for name, (cin, cout, (kh, kw), _, _) in sorted(jax_conv_specs().items()):
        w = rng.standard_normal((kh, kw, cin, cout), np.float32)
        raw[f"{name}/w"] = w * np.float32(np.sqrt(2.0 / (kh * kw * cin)))
        raw[f"{name}/b"] = rng.normal(0, 0.01, cout).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in raw.items()}, inc.params_from_numpy(raw)


def _features_close(jp, tp, x, **kw):
    want = np.asarray(jinc.inception_features(jp, jnp.asarray(x), **kw))
    got = inc.inception_features(tp, torch.from_numpy(x).permute(0, 3, 1, 2), **kw).numpy()
    assert got.shape == want.shape == (x.shape[0], inception_spec.FEATURE_DIM)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("count_include_pad", [False, True])
def test_inception_features_match_jax(params, count_include_pad):
    """Two 299 x 299 images, no resize: every block under both average-pool
    modes (pytorch-fid's and torchvision's). 299 is the network's input,
    so the resized case below reuses JAX's op-by-op compiles."""
    x = np.random.default_rng(0).random((2, 299, 299, 3), np.float32)
    _features_close(*params, x, resize=False, count_include_pad=count_include_pad)


def test_inception_features_resized_match_jax(params):
    """Two 48 x 48 images resized to 299 (the bilinear resize of both)."""
    x = np.random.default_rng(1).random((2, 48, 48, 3), np.float32)
    _features_close(*params, x)


def test_inception_spec_and_init_structure():
    assert inception_spec.conv_specs() == jax_conv_specs()
    p = inc.init_inception_params()
    assert len(p) == 2 * 94
    assert p["Conv2d_1a_3x3/w"].shape == (32, 3, 3, 3)  # OIHW
    again = inc.init_inception_params()
    assert all(torch.equal(p[k], again[k]) for k in p)  # seeded: seed 0 by default
    w = p["Mixed_7c.branch_pool/w"]
    assert w.shape == (192, 2048, 1, 1)
    assert abs(w.std().item() / np.sqrt(2.0 / 2048) - 1) < 0.05  # He-normal


def test_npz_round_trip_and_feature_fn_choice(params, tmp_path, monkeypatch):
    """The .npz schema (HWIO) loads into the port's tensors, and
    make_fid_feature_fn reports 'rfid' with it, 'vgg_rfid' without."""
    jp, tp = params
    path = tmp_path / "inception_v3.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in jp.items()})
    loaded = inc.load_inception_params(str(path))
    assert loaded.keys() == tp.keys() and all(torch.equal(loaded[k], tp[k]) for k in tp)

    monkeypatch.setattr(inc, "DEFAULT_WEIGHTS_PATH", str(tmp_path / "absent.npz"))
    assert not inc.inception_params_available()
    assert inc.load_inception_params() is None
    _, key = ev.make_fid_feature_fn("cpu")
    assert key == "vgg_rfid"

    monkeypatch.setattr(inc, "DEFAULT_WEIGHTS_PATH", str(path))
    fn, key = ev.make_fid_feature_fn("cpu")
    assert key == "rfid"
    x = np.random.default_rng(2).random((1, 64, 64, 3), np.float32)
    got = fn(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    want = inc.inception_features(loaded, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.array_equal(got, want)


def test_rfid_of_inception_features(params):
    """``utils.fid.rfid`` over Inception features (the first 16 of 2048: a
    2048-wide sqrtm takes a minute here): 0 for a set against itself,
    positive against a perturbed set and equal to the JAX package's
    Fréchet distance of the same features (float64, 1e-6 relative)."""
    from deepl_project_tpu.utils.fid import fid_from_features as jax_fid

    _, tp = params
    rng = np.random.default_rng(4)
    real = [torch.from_numpy(rng.random((10, 3, 80, 80), np.float32)) for _ in range(2)]
    fake = [(r + torch.from_numpy(rng.normal(0, 0.1, r.shape).astype(np.float32))).clamp(0, 1)
            for r in real]

    def feature_fn(x):
        return inc.inception_features(tp, x, resize=False)[:, :16].double()

    assert abs(fid.rfid(real, real, feature_fn)) < 1e-6
    got = fid.rfid(real, fake, feature_fn)
    want = jax_fid(np.concatenate([feature_fn(r).numpy() for r in real]),
                   np.concatenate([feature_fn(f).numpy() for f in fake]))
    assert got > 0 and abs(got - want) <= 1e-6 * got
