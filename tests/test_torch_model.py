"""The port's TransVAE against the JAX package's, on converted weights.

Weights are drawn by the port (seeded torch.Generator), taken to the JAX tree
with the JAX package's ``torch_state_dict_to_params``, and loaded back into a
second port model with the port's own ``load_jax_params`` -- so both
converters are exercised and both models hold the same numbers. Inputs are
seeded numpy arrays, NHWC for JAX and NCHW for the port.

Tolerances: fp32, atol 5e-4 + rtol 1e-4 (five stages of convs, norms and
attention summed in other orders, and the JAX package's exact rewrites
against the port's literal op order); bf16, 0.05 * max|ref| on the decoder
logits (each package rounds to bf16 at dozens of places, and a rounding
difference early in the encoder travels through both halves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import VARIANTS, count_params, create_transvae, get_config
from deepl_project_tpu_torch.models import TransVAE, init_weights
from deepl_project_tpu_torch.utils.convert import load_jax_params, params_to_torch_state_dict

torch.set_num_threads(2)
MICRO = dict(depths=(1, 1, 1, 1, 1), base_dims=(16, 16, 32, 64, 64), latent_dim=4,
             head_dim=16, dtype="float32")
# bf16 with head_dim 64 and 128-wide transformer stages: the attention
# sublayers dispatch to the kernel wrappers (their plain versions on CPU).
MICRO_BF16 = dict(depths=(1, 1, 1, 1, 1), base_dims=(16, 16, 128, 128, 128),
                  latent_dim=4, head_dim=64, dtype="bfloat16")


def _pair(kw, seed=0):
    """(port model, JAX model, JAX params) holding the same weights."""
    cfg = get_config("tiny_f16d32", **kw)
    src = TransVAE(cfg, device="cpu")
    init_weights(src, torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    jcfg = jax_get_config("tiny_f16d32", **kw)
    params = torch_state_dict_to_params(sd, jcfg)
    port = TransVAE(cfg, device="cpu").eval()
    load_jax_params(port, params)
    return port, JaxTransVAE(jcfg), params


@pytest.fixture(scope="module")
def micro():
    return _pair(MICRO)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def test_forward_matches_jax(micro):
    port, jm, params = micro
    x = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, sample=False))(params, x)
    with torch.inference_mode():
        got = port(_nchw(x), sample=False)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=5e-4, rtol=1e-4)


def test_encode_decode_match_jax(micro):
    port, jm, params = micro
    rng = np.random.default_rng(1)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    z = rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
    enc = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=lambda m, x: m.encode(x)))
    dec = jax.jit(lambda p, z: jm.apply({"params": p}, z, method=lambda m, z: m.decode(z)))
    with torch.inference_mode():
        mu, logvar = port.encode(_nchw(x))
        img = port.decode(_nchw(z))
    for r, g in zip(enc(params, x), (mu, logvar)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(_nhwc(img), np.asarray(dec(params, z)), atol=5e-4, rtol=1e-4)


def test_state_dict_is_reference_layout(micro):
    port, _, params = micro
    ours = params_to_torch_state_dict(params)
    theirs = jax_to_sd(params, None)
    assert set(ours) == set(theirs) == set(port.state_dict())
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
        np.testing.assert_array_equal(port.state_dict()[k].numpy(), ours[k])


def test_forward_bf16_matches_jax():
    port, jm, params = _pair(MICRO_BF16, seed=1)
    x = np.random.default_rng(2).random((1, 64, 64, 3), dtype=np.float32)
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, sample=False))(params, x)
    with torch.inference_mode():
        got = port(_nchw(x), sample=False)
    for r, g in zip(ref, got):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(_nhwc(g), r, atol=0.05 * np.abs(r).max(), rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_counts_match_jax(variant):
    # Analytic on both sides: meta tensors in the port, eval_shape in JAX
    # (scan_blocks stacks each stage's blocks: the same parameters, traced
    # once per stage, which keeps the largest variants quick).
    with torch.device("meta"):
        port = TransVAE(get_config(variant))
    jm = JaxTransVAE(jax_get_config(variant, scan_blocks=True))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 32, 32, 3), jnp.bfloat16),
                                            sample=False))["params"]
    counts = count_params(port)
    assert counts["total"] == sum(int(np.prod(s.shape))
                                  for s in jax.tree_util.tree_leaves(shapes))
    assert counts["encoder"] == sum(int(np.prod(s.shape))
                                    for s in jax.tree_util.tree_leaves(shapes["encoder"]))
    if variant == "large_f16d32":
        assert counts["total"] == 1_049_213_827


def test_clamps_and_mean_decoding():
    model = create_transvae("tiny_f16d32", device="cpu", seed=0, **MICRO)
    with torch.no_grad():
        model.conv_mu.bias.fill_(100.0)
        model.conv_logvar.bias.fill_(-100.0)
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, mu, logvar = model(x)
        assert float(mu.min()) == 50.0 and float(logvar.max()) == -30.0
        raw_mu, _ = model.encode(x)
        assert float(raw_mu.min()) > 50.0  # encode itself does not clamp
        with pytest.raises(NotImplementedError):
            model(x, sample=True)  # sampling belongs to training


def test_seeded_init_is_reproducible_and_small_latent_heads():
    a = create_transvae("tiny_f16d32", device="cpu", seed=5, **MICRO)
    b = create_transvae("tiny_f16d32", device="cpu", seed=5, **MICRO)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, msg=k)
    # variance_scaling(1e-4, fan_in) on the latent heads: std ~ 1e-2/sqrt(9*64)
    assert a.conv_mu.weight.detach().std() < 1e-3 < a.encoder.conv_in.weight.detach().std()


@pytest.mark.parametrize("field,value", [("scan_blocks", True), ("remat", True),
                                         ("quant", "int8"), ("context_axis", "context"),
                                         ("dropout", 0.1)])
def test_settings_not_yet_ported_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        TransVAE(get_config("tiny_f16d32", **MICRO, **{field: value}), device="meta")
