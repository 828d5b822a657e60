"""The port's evaluation slice against the JAX package: metrics summary,
image helpers and PNG writing, FID, the extrapolation resize, the metric
step, ``evaluate_model``, ``extrapolation_sweep``, generation, and the three
CLIs under ``--device cpu``.

Models are micro TransVAEs (five stages of depth 1, head_dim 16, fp32) whose
weights the port draws from a seeded torch.Generator and the JAX package
receives through its ``torch_state_dict_to_params``; images are the seeded
``shapes`` source, NHWC as both packages take them at their public functions.

Tolerances: per-image PSNR and SSIM within 1e-4 (fp32 models of five stages,
summed in other orders); LPIPS 1e-4 relative; the resize 1e-5 (the same
triangle weights); FID 1e-6 relative (the same float64 numpy/scipy math);
summaries, grids and PNG pixels exact.
"""

import json
import os

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

import deepl_project_tpu.evaluation as jeval
from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.utils import fid as jfid
from deepl_project_tpu.utils import image as jimage
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu.utils.metrics import summarize as jax_summarize
from deepl_project_tpu_torch import evaluation as ev
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.cli import evaluate as cli_evaluate
from deepl_project_tpu_torch.cli import generate as cli_generate
from deepl_project_tpu_torch.cli import rope_extrapolation as cli_rope
from deepl_project_tpu_torch.data import batch_iterator, make_dataset
from deepl_project_tpu_torch.losses import init_lpips_params
from deepl_project_tpu_torch.models import TransVAE, init_weights
from deepl_project_tpu_torch.training.checkpoint import save_checkpoint
from deepl_project_tpu_torch.utils import fid, image
from deepl_project_tpu_torch.utils.metrics import summarize

torch.set_num_threads(2)
MICRO = dict(depths=(1, 1, 1, 1, 1), base_dims=(16, 16, 32, 64, 64), latent_dim=4,
             head_dim=16, dtype="float32")


@pytest.fixture(scope="module")
def micro():
    """(port model, JAX model, JAX params) holding the same weights."""
    cfg = get_config("tiny_f16d32", **MICRO)
    model = TransVAE(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = jax_get_config("tiny_f16d32", **MICRO)
    return model.eval(), JaxTransVAE(jcfg), torch_state_dict_to_params(sd, jcfg)


def _images(n, res, seed=0):
    return next(batch_iterator(make_dataset("shapes", resolution=res, seed=seed), n))


def _lpips_pair(seed=0):
    """LPIPS params for the port (OIHW) and the JAX package (HWIO)."""
    p = init_lpips_params(torch.Generator().manual_seed(seed))
    jp = {"conv": {k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4
                                  else v.numpy()) for k, v in p["conv"].items()},
          "lin": {k: jnp.asarray(v.numpy()) for k, v in p["lin"].items()}}
    return p, jp


def test_summarize_matches_jax():
    v = np.random.default_rng(0).standard_normal(37).astype(np.float32)
    assert summarize(v) == jax_summarize(v)
    assert summarize(torch.from_numpy(v)) == jax_summarize(v)


def test_image_helpers_match_jax():
    rng = np.random.default_rng(1)
    imgs = rng.random((5, 6, 7, 3)).astype(np.float32)
    for nrow in (2, 8):
        np.testing.assert_array_equal(image.make_grid(imgs, nrow=nrow),
                                      jimage.make_grid(imgs, nrow=nrow))
    np.testing.assert_array_equal(image.to_uint8(imgs), jimage.to_uint8(imgs))
    x = rng.random((2, 3, 4, 5))
    np.testing.assert_array_equal(image.nchw_to_nhwc(x), jimage.nchw_to_nhwc(x))
    np.testing.assert_array_equal(image.nhwc_to_nchw(x), jimage.nhwc_to_nchw(x))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(tmp_path, channels):
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(channels).random((9, 13, channels)).astype(np.float32)
    path = str(tmp_path / "x.png")
    image.save_image(img, path)
    with Image.open(path) as f:
        back = np.asarray(f)
    np.testing.assert_array_equal(back.reshape(img.shape), image.to_uint8(img))
    grid = str(tmp_path / "grid.png")
    image.save_grid(np.stack([img] * 3), grid, nrow=2)
    with Image.open(grid) as f:
        assert f.size == (2 * 13 + 6, 2 * 9 + 6)


def test_fid_matches_jax():
    rng = np.random.default_rng(2)
    real = rng.standard_normal((64, 8))
    fake = 0.5 + 1.3 * rng.standard_normal((64, 8))
    for got, want in zip(fid.feature_statistics(real), jfid.feature_statistics(real)):
        np.testing.assert_array_equal(got, want)
    d = fid.fid_from_features(real, fake)
    assert d == pytest.approx(jfid.fid_from_features(real, fake), rel=1e-6)
    assert fid.frechet_distance(*fid.feature_statistics(real),
                                *fid.feature_statistics(real)) == pytest.approx(0, abs=1e-6)
    batches = [real[:32], real[32:]], [fake[:32], fake[32:]]
    assert fid.rfid(*batches, lambda b: torch.from_numpy(b)) == pytest.approx(d, rel=1e-9)


@pytest.mark.parametrize("src,dst", [(64, 32), (64, 16), (48, 64)])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(3).random((2, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method="linear"))
    got = ev.resize_images(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)


def test_metric_step_matches_jax(micro):
    model, jm, params = micro
    lp, jlp = _lpips_pair()
    x = _images(2, 32)
    recon_j, want = jeval.make_metric_step(jm, jlp)(params, jnp.asarray(x))
    recon, got = ev.make_metric_step(model, lp)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(recon.permute(0, 2, 3, 1).numpy(), np.asarray(recon_j),
                               atol=1e-4, rtol=0)
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["lpips"].numpy(), np.asarray(want["lpips"]), rtol=1e-4)


def test_evaluate_model_matches_jax(micro, tmp_path):
    model, jm, params = micro
    data = list(batch_iterator(make_dataset("shapes", resolution=32, num_samples=6), 3))
    want = jeval.evaluate_model(jm, params, iter(data), use_lpips=False)
    out = str(tmp_path / "eval")
    got = ev.evaluate_model(model, {"model": model.state_dict()}, iter(data),
                            use_lpips=False, output_dir=out, save_grids=1)
    assert got["num_images"] == want["num_images"] == 6
    for key in ("psnr", "ssim"):
        for stat in ("mean", "min", "max"):
            assert got[key][stat] == pytest.approx(want[key][stat], abs=1e-4)
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f) == got
    assert sorted(os.listdir(out)) == ["comparison_000.png", "metrics.json"]


def test_evaluate_model_lpips_and_vgg_rfid(micro):
    model, _, _ = micro
    data = batch_iterator(make_dataset("shapes", resolution=32, num_samples=4), 2)
    lp, _ = _lpips_pair(1)
    got = ev.evaluate_model(model, None, data, compute_rfid=True, lpips_params=lp)
    assert set(got) == {"psnr", "ssim", "lpips", "num_images", "vgg_rfid"}
    assert np.isfinite(got["vgg_rfid"]) and got["lpips"]["mean"] > 0
    feats = ev.make_vgg_feature_fn(lp)(torch.rand(3, 3, 32, 32))
    assert feats.shape == (3, 512)


def test_extrapolation_sweep_matches_jax(micro):
    model, jm, params = micro
    imgs = _images(4, 64, seed=1)
    want = jeval.extrapolation_sweep(jm, params, imgs, (32, 64), chunk=2)
    got = ev.extrapolation_sweep(model, None, imgs, (32, 64), chunk=2)
    assert set(got) == set(want) == {32, 64}
    for res in (32, 64):
        for stat in ("mean", "std", "min", "max"):
            assert got[res][stat] == pytest.approx(want[res][stat], abs=1e-4)
            assert got[res]["ssim"][stat] == pytest.approx(want[res]["ssim"][stat], abs=1e-4)


def test_generation_functions(micro):
    model, _, _ = micro
    a, b = _images(2, 32, seed=2)
    rec = ev.reconstruct(model, None, np.stack([a, b]))
    inter = ev.generate_interpolation(model, None, a, b, steps=4)
    assert rec.shape == (2, 32, 32, 3) and inter.shape == (4, 32, 32, 3)
    # The end points decode each image's mean: its reconstruction.
    np.testing.assert_allclose(inter[[0, -1]], rec, atol=1e-5, rtol=0)
    g1 = ev.generate_random(model, None, torch.Generator().manual_seed(3), 3, 2)
    g2 = ev.generate_random(model, None, torch.Generator().manual_seed(3), 3, 2)
    np.testing.assert_array_equal(g1, g2)
    assert g1.shape == (3, 32, 32, 3) and 0 <= g1.min() and g1.max() <= 1


@pytest.fixture(scope="module")
def micro_checkpoint(micro, tmp_path_factory):
    model = micro[0]
    directory = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(directory, 1, {"model": model.state_dict(), "step": 1},
                    config=model.config)
    return directory


def test_evaluate_cli_on_cpu(micro_checkpoint, tmp_path, capsys):
    out = str(tmp_path / "eval")
    got = cli_evaluate.main(["--checkpoint", micro_checkpoint, "--device", "cpu",
                             "--data", "shapes", "--resolution", "32", "--batch_size", "2",
                             "--num_batches", "2", "--no_lpips", "--output_dir", out,
                             "--save_grids", "1"])
    assert got["num_images"] == 4 and np.isfinite(got["psnr"]["mean"])
    assert json.loads(capsys.readouterr().out) == got
    assert os.path.exists(os.path.join(out, "comparison_000.png"))


def test_generate_cli_on_cpu(micro_checkpoint, tmp_path):
    out = str(tmp_path / "gen")
    cli_generate.main(["--mode", "random", "--checkpoint", micro_checkpoint, "--device",
                       "cpu", "--num_samples", "2", "--latent_hw", "2", "--output_dir", out])
    assert sorted(os.listdir(out)) == ["random.png", "sample_000.png", "sample_001.png"]
    pytest.importorskip("PIL")
    src = str(tmp_path / "in.png")
    image.save_image(_images(1, 40)[0], src)
    for mode, extra, name in (("reconstruct", [], "reconstruction.png"),
                              ("interpolate", ["--image_b", src, "--steps", "3"],
                               "interpolation.png")):
        cli_generate.main(["--mode", mode, "--checkpoint", micro_checkpoint, "--device",
                           "cpu", "--image", src, "--resolution", "32",
                           "--output_dir", out, *extra])
        assert name in os.listdir(out)
    with pytest.raises(SystemExit):
        cli_generate.main(["--mode", "reconstruct", "--device", "cpu"])


def test_rope_extrapolation_cli_matches_jax_sweep(micro, micro_checkpoint):
    _, jm, params = micro
    got = cli_rope.main(["--checkpoint", micro_checkpoint, "--device", "cpu",
                         "--resolutions", "32", "64", "--num_images", "4", "--chunk", "4"])
    want = jeval.extrapolation_sweep(jm, params, _images(4, 64), (32, 64), chunk=4)
    for res in (32, 64):
        assert got[str(res)]["mean"] == pytest.approx(want[res]["mean"], abs=1e-4)
        assert got[str(res)]["ssim"]["mean"] == pytest.approx(want[res]["ssim"]["mean"],
                                                              abs=1e-4)


def test_preprocess_file_matches_jax(tmp_path):
    pytest.importorskip("PIL")
    from deepl_project_tpu.data.transforms import preprocess_file as jax_preprocess
    from deepl_project_tpu_torch.data import preprocess_file

    path = str(tmp_path / "wide.png")
    image.save_image(np.random.default_rng(4).random((30, 50, 3)).astype(np.float32), path)
    np.testing.assert_array_equal(preprocess_file(path, 24), jax_preprocess(path, 24))
