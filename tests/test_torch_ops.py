"""The port's building blocks against the JAX package's flax modules.

Each flax module is initialised, its params are converted with the port's
own ``params_to_torch_state_dict`` and loaded into the port's module with
``strict=True``, and both run on the same seeded numpy input (NHWC for the
flax module, NCHW for the port). fp32 throughout: ATOL/RTOL 2e-4 for single
ops (other summation orders, and the JAX package's exact rewrites --
ConvFFN fold_output, the fused resample convs -- against the port's literal
op order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu.ops import blocks as jblocks
from deepl_project_tpu.ops import ffn as jffn
from deepl_project_tpu.ops import norms as jnorms
from deepl_project_tpu.ops import resample as jresample
from deepl_project_tpu.ops.rope import apply_rope2d as japply_rope2d
from deepl_project_tpu_torch.ops import blocks, ffn, norms, resample
from deepl_project_tpu_torch.ops.rope import apply_rope2d
from deepl_project_tpu_torch.utils.convert import load_state_dict, params_to_torch_state_dict

torch.set_num_threads(2)
ATOL = RTOL = 2e-4
F32 = jnp.float32


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _run_pair(jmod, tmod, x_nhwc, wrap=None):
    """Init the flax module, load its params into the port's module, run
    both; returns (jax NHWC output, port output as NHWC numpy)."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x_nhwc))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # Non-trivial norm affines/biases (flax inits them to ones/zeros).
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                      if p[-1].key in ("scale", "bias") else v), params)
    tree, prefix = params, ""
    if wrap is not None:  # resample modules are named by their position
        tree, prefix = {wrap[0]: {wrap[1]: params}}, wrap[2]
    sd = {k[len(prefix):]: v for k, v in params_to_torch_state_dict(tree).items()}
    load_state_dict(tmod, sd)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x_nhwc)))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous())
    return ref, got.permute(0, 2, 3, 1).numpy()


def _close(ref, got, atol=ATOL, rtol=RTOL):
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def test_rms_norm():
    x = _x((2, 4, 4, 32), scale=3.0)
    _close(*_run_pair(jnorms.RMSNorm(32, dtype=F32), norms.RMSNorm(32), x))


def test_group_norm_single_pass_moments():
    # Large mean against a small spread: the single-pass E[x^2]-E[x]^2 moments
    # of the JAX module, clamped at 0, reproduced in the port.
    x = _x((2, 8, 8, 64)) + 4.0
    _close(*_run_pair(jnorms.GroupNorm(32, 64, dtype=F32), norms.GroupNorm(32, 64), x))
    for dim in (16, 24, 64, 192):
        assert norms.gn_groups(dim) == jnorms.gn_groups(dim)


def test_layer_norm():
    x = _x((2, 10, 48), scale=2.0) + 1.0
    jmod, tmod = jnorms.LayerNorm(48, dtype=F32), norms.LayerNorm(48)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), x)["params"])
    params = {"scale": params["scale"] + 0.5, "bias": params["bias"] - 0.25}
    load_state_dict(tmod, params_to_torch_state_dict(params))
    ref = np.asarray(jmod.apply({"params": params}, x))
    _close(ref, tmod(torch.from_numpy(x)).detach().numpy())


@pytest.mark.parametrize("pairing", ["reference", "standard"])
def test_apply_rope2d(pairing):
    x = _x((2, 6 * 8, 3, 16))
    ref = np.asarray(japply_rope2d(jnp.asarray(x), 6, 8, pairing))
    _close(ref, apply_rope2d(torch.from_numpy(x), 6, 8, pairing).numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("conv_type,fold", [("full", True), ("full", False),
                                            ("depthwise", False)])
def test_conv_ffn(conv_type, fold):
    x = _x((2, 6, 6, 16))
    jmod = jffn.ConvFFN(16, conv_type=conv_type, fold_output=fold, dtype=F32)
    _close(*_run_pair(jmod, ffn.ConvFFN(16, conv_type=conv_type), x))


def test_standard_ffn():
    x = _x((2, 4, 4, 16))
    _close(*_run_pair(jffn.StandardFFN(16, dtype=F32), ffn.StandardFFN(16), x))


@pytest.mark.parametrize("cin,cout,conv_sc", [(16, 16, False), (16, 32, False),
                                              (16, 32, True)])
def test_res_block(cin, cout, conv_sc):
    x = _x((2, 8, 8, cin))
    jmod = jblocks.ResBlock(cin, cout, use_conv_shortcut=conv_sc, dtype=F32)
    _close(*_run_pair(jmod, blocks.ResBlock(cin, cout, conv_sc), x))


@pytest.mark.parametrize("use_conv_ffn,pairing", [(True, "reference"), (False, "standard")])
def test_transvae_block(use_conv_ffn, pairing):
    x = _x((2, 4, 6, 32))
    jmod = jblocks.TransVAEBlock(32, head_dim=16, rope_pairing=pairing,
                                 use_conv_ffn=use_conv_ffn, dtype=F32)
    tmod = blocks.TransVAEBlock(32, head_dim=16, rope_pairing=pairing,
                                use_conv_ffn=use_conv_ffn)
    _close(*_run_pair(jmod, tmod, x))


@pytest.mark.parametrize("dc", [True, False])
def test_downsample(dc):
    x = _x((2, 8, 8, 16))
    jmod = jresample.Downsample(16, 32, use_dc_path=dc, dtype=F32)
    _close(*_run_pair(jmod, resample.Downsample(16, 32, dc), x,
                      wrap=("encoder", "down0", "encoder.downsamples.0.")))


@pytest.mark.parametrize("dc", [True, False])
def test_upsample(dc):
    x = _x((2, 4, 4, 32))
    jmod = jresample.Upsample(32, 16, use_dc_path=dc, dtype=F32)
    _close(*_run_pair(jmod, resample.Upsample(32, 16, dc), x,
                      wrap=("decoder", "up0", "decoder.upsamples.0.")))
