"""The port's thin 3x3 convolutions (``deepl_project_tpu_torch/ops/
thin_conv.py``) against the JAX package's ``ops/thin_conv.py`` on the CPU.

The JAX module's parameters (its initializer's kernel, a random bias) are
converted with the port's ``params_to_torch_state_dict`` (the ``kernel``
rule: HWIO -> OIHW) and loaded into the port's ``ThinConv3x3`` with
strict=True; both run on the same seeded numpy input, NHWC for JAX and NCHW
for the port, at ``tests/test_ops.py``'s (Ci, Co) cases: (3, 24) and
(32, 24) take the im2col form, (24, 3) the tap-major form, (48, 40) the
native convolution. Ci and Co are both above 1 and unequal in three of
them and the map is not square, so a swapped (dy, dx, ci) order of the
weight fails.

Tolerances: fp32 1e-5 abs and rel (the JAX test's: sums in other orders).
bf16: 2^-7 x max|y|, one bf16 step at the largest magnitude (both packages
round the operands to bf16 and the output once; an fp32 sum in another
order can land on the other side of a rounding boundary). Gradients (fp32,
against ``jax.vjp``): 1e-5 x max|grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu.ops import thin_conv as jthin
from deepl_project_tpu_torch.ops import thin_conv
from deepl_project_tpu_torch.utils.convert import load_state_dict, params_to_torch_state_dict

torch.set_num_threads(2)
CASES = [(3, 24), (32, 24), (24, 3), (48, 40)]
H, W = 9, 7


def _pair(ci, co, dtype, use_bias=True):
    """(JAX module, its params, the port's module holding them)."""
    jm = jthin.ThinConv3x3(ci, co, use_bias=use_bias, dtype=dtype, param_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(ci * 100 + co), jnp.zeros((1, H, W, ci)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if use_bias:
        params["bias"] = np.random.default_rng(co).standard_normal(co).astype(np.float32)
    pm = thin_conv.ThinConv3x3(ci, co, use_bias=use_bias)
    load_state_dict(pm, params_to_torch_state_dict(params))
    return jm, params, pm


def _x(ci, seed=0):
    return np.random.default_rng(seed).standard_normal((2, H, W, ci)).astype(np.float32)


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _bar(want, bf16):
    return (dict(atol=2 ** -7 * np.abs(want).max(), rtol=0) if bf16
            else dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci,co", CASES)
def test_thin_conv_module_matches_jax(ci, co, dtype):
    bf16 = dtype == "bfloat16"
    jm, params, pm = _pair(ci, co, jnp.bfloat16 if bf16 else jnp.float32)
    assert set(pm.state_dict()) == {"weight", "bias"}
    assert pm.weight.shape == (co, ci, 3, 3)
    x = _x(ci)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = pm(_nchw(x, torch.bfloat16 if bf16 else torch.float32))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got.shape == (2, co, H, W)
    np.testing.assert_allclose(_nhwc(got), want, **_bar(want, bf16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci,co", CASES)
def test_thin_conv_functions_match_jax(ci, co, dtype):
    # Both forms at every case, the bias present and absent, on the same
    # weights; each also equals the native convolution in fp32.
    bf16 = dtype == "bfloat16"
    _, params, pm = _pair(ci, co, jnp.float32)
    x = _x(ci, seed=1)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = _nchw(x, torch.bfloat16 if bf16 else torch.float32)
    native = torch.nn.functional.conv2d(_nchw(x), pm.weight, pm.bias, padding=1)
    for jfn, fn in ((jthin.thin_input_conv3x3, thin_conv.thin_input_conv3x3),
                    (jthin.thin_output_conv3x3, thin_conv.thin_output_conv3x3)):
        for bias in (params["bias"], None):
            want = np.asarray(jfn(jx, jnp.asarray(params["kernel"]),
                                  None if bias is None else jnp.asarray(bias)
                                  ).astype(jnp.float32))
            with torch.no_grad():
                got = fn(tx, pm.weight, None if bias is None else pm.bias)
            assert got.dtype == tx.dtype and got.shape == (2, co, H, W)
            np.testing.assert_allclose(_nhwc(got), want, **_bar(want, bf16))
            if not bf16 and bias is not None:
                np.testing.assert_allclose(_nhwc(got), _nhwc(native), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ci,co", CASES)
def test_thin_conv_gradients_match_jax(ci, co):
    # d/dx, d/dweight and d/dbias of each form (and of the module's) against
    # jax.vjp of the JAX function on the same cotangent, fp32.
    jm, params, pm = _pair(ci, co, jnp.float32)
    x = _x(ci, seed=2)
    ct = np.random.default_rng(3).standard_normal((2, H, W, co)).astype(np.float32)
    jfns = {"input": jthin.thin_input_conv3x3, "output": jthin.thin_output_conv3x3,
            "module": lambda xx, k, b: jm.apply({"params": {"kernel": k, "bias": b}}, xx)}
    fns = {"input": thin_conv.thin_input_conv3x3, "output": thin_conv.thin_output_conv3x3,
           "module": lambda xx, k, b: pm(xx)}
    for form, jfn in jfns.items():
        grads = jax.jit(lambda xx, k, b, c, f=jfn: jax.vjp(f, xx, k, b)[1](c))(
            jnp.asarray(x), jnp.asarray(params["kernel"]), jnp.asarray(params["bias"]),
            jnp.asarray(ct))
        gx, gk, gb = (np.asarray(g) for g in grads)
        tx = _nchw(x).requires_grad_(True)
        pm.zero_grad()
        y = fns[form](tx, pm.weight, pm.bias)
        y.backward(_nchw(ct))
        got = (_nhwc(tx.grad), pm.weight.grad.permute(2, 3, 1, 0).numpy(), pm.bias.grad.numpy())
        for g, want in zip(got, (gx, gk, gb)):
            np.testing.assert_allclose(g, want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                       err_msg=form)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_thin_conv_keeps_the_memory_format_and_no_bias(layout):
    # The output keeps x's memory format; use_bias=False has no bias
    # parameter, as the JAX module has no bias leaf.
    jm, params, pm = _pair(24, 3, jnp.float32, use_bias=False)
    assert set(params) == {"kernel"} and set(pm.state_dict()) == {"weight"}
    x = _x(24, seed=4)
    tx = _nchw(x)
    if layout == "channels_last":
        tx = tx.contiguous(memory_format=torch.channels_last)
    for fn in (thin_conv.thin_input_conv3x3, thin_conv.thin_output_conv3x3):
        with torch.no_grad():
            got = fn(tx, pm.weight, None)
        assert got.is_contiguous(memory_format=torch.channels_last if layout != "nchw"
                                 else torch.contiguous_format)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
        np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=1e-5)
