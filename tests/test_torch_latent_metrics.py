"""The port's latent diagnostics against the JAX package's, on the CPU.

The histogram metrics are the same numpy code: equal. The linear probe
trains with torch.optim.Adam where JAX uses optax's adam (the same update):
equal accuracies, ``final_loss`` within 1e-4 (fp32, 300 steps, sums in
other orders). ``pool_latents`` of a micro TransVAE (fp32) on the same
weights within 1e-5 absolute of JAX's (pooled latents of magnitude ~0.4).
"""

import numpy as np
import pytest
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.utils import latent_metrics as jlm
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.data import batch_iterator, make_dataset
from deepl_project_tpu_torch.models import TransVAE, init_weights
from deepl_project_tpu_torch.utils import latent_metrics as lm

torch.set_num_threads(2)
MICRO = dict(depths=(1, 1, 1, 1, 1), base_dims=(16, 16, 32, 64, 64), latent_dim=4,
             head_dim=16, dtype="float32")


@pytest.mark.parametrize("scale", [0.3, 1.0, 4.0])
def test_histogram_metrics_equal_jax(scale):
    lat = np.random.default_rng(0).normal(0, scale, (8, 16, 16, 4)).astype(np.float32)
    assert lm.latent_diagnostics(lat) == jlm.latent_diagnostics(lat)
    assert lm.latent_diagnostics(lat, bins=64) == jlm.latent_diagnostics(lat, bins=64)
    assert np.array_equal(lm.latent_histogram(lat), jlm.latent_histogram(lat))


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_probe_matches_optax(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, 80)
    feats = rng.normal(size=(80, 12)).astype(np.float32)
    feats[:, :4] += 1.2 * np.eye(4, dtype=np.float32)[labels]
    kw = dict(num_classes=4, steps=300, lr=1e-2, seed=seed)
    ours, theirs = lm.linear_probe(feats, labels, **kw), jlm.linear_probe(feats, labels, **kw)
    assert ours["train_acc"] == pytest.approx(theirs["train_acc"], abs=1e-6)
    assert ours["val_acc"] == pytest.approx(theirs["val_acc"], abs=1e-6)
    assert abs(ours["final_loss"] - theirs["final_loss"]) <= 1e-4
    assert ours == lm.linear_probe(torch.from_numpy(feats), labels, **kw)


def test_pool_latents_matches_jax():
    cfg = get_config("tiny_f16d32", **MICRO)
    model = TransVAE(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = jax_get_config("tiny_f16d32", **MICRO)
    jparams = torch_state_dict_to_params(sd, jcfg)

    def batches():
        return batch_iterator(make_dataset("shapes", 32, num_samples=6, seed=3), 3)

    ours = lm.pool_latents(model, None, batches())
    theirs = jlm.pool_latents(JaxTransVAE(jcfg), {"model": jparams}, batches())
    assert ours.shape == theirs.shape == (6, 4)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    assert np.array_equal(lm.pool_latents(model, {"model": model.state_dict()}, batches()),
                          ours)
