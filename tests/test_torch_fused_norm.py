"""Rows 7-8 of the TPU kernel table, ``group_norm_silu`` (stats and apply),
against the JAX package.

The port's plain version (what its wrapper computes for CPU tensors) and the
composition of the plain versions of its two kernel passes with the torch
epilogue are held against the JAX function, whose two ``pl.pallas_call``s run
in interpret mode inside the test (nothing of the JAX package changes). The
port is NCHW, the JAX function NHWC; the inputs are the same numpy arrays.
The CUDA kernels run only on a card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).

Tolerances: fp32, 1e-4 rel + 1e-5 abs (fp32 sums over a group in other
orders); bf16, 2**-6 * max|ref| (the output is rounded once in both, an fp32
difference can land on the other side of a bf16 rounding boundary).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepl_project_tpu.ops.pallas.fused_norm as jfnorm
from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
from deepl_project_tpu_torch.ops.norms import GroupNorm

torch.set_num_threads(2)


@pytest.fixture
def jax_group_norm_silu(monkeypatch):
    monkeypatch.setattr(jfnorm.pl, "pallas_call",
                        functools.partial(jfnorm.pl.pallas_call, interpret=True))
    return jfnorm.group_norm_silu


def _inputs(b=2, c=64, h=16, w=8, seed=0):
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((b, h, w, c)) + 1).astype(np.float32)  # NHWC
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)


@pytest.mark.parametrize("dtype,silu", [("float32", True), ("float32", False),
                                        ("bfloat16", True)])
def test_group_norm_silu_plain_matches_pallas_interpret(jax_group_norm_silu, dtype, silu):
    x, scale, bias = _inputs()
    jdt = getattr(jnp, dtype)
    want = jax_group_norm_silu(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                               groups=8, silu=silu, block_rows=64)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    tx = _nchw(x, getattr(torch, dtype))
    got = fnorm.group_norm_silu(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                                groups=8, silu=silu)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 ** -6 * np.abs(want).max(), rtol=0)


def test_kernel_passes_compose_to_the_plain_version():
    # What the card runs -- stats pass, torch epilogue, apply pass -- in their
    # plain versions equals the plain function, which equals the port's
    # GroupNorm module followed by SiLU.
    x, scale, bias = _inputs(c=96, seed=1)
    tx, ts, tb = _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)
    stats = fnorm.group_stats_reference(tx, 32)
    mul, add = fnorm.mul_add(stats, 3 * 16 * 8, ts, tb, 1e-5)
    got = fnorm.apply_reference(tx, mul, add)
    want = fnorm.group_norm_silu_reference(tx, ts, tb, groups=32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    gn = GroupNorm(32, 96)
    with torch.no_grad():
        gn.weight.copy_(ts)
        gn.bias.copy_(tb)
        torch.testing.assert_close(want, torch.nn.functional.silu(gn(tx)),
                                   atol=1e-5, rtol=1e-4)


def test_group_norm_silu_is_forward_only_and_refuses_off_cpu_tensors():
    x, scale, bias = _inputs()
    tx = _nchw(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fnorm.group_norm_silu(tx, torch.from_numpy(scale), torch.from_numpy(bias), groups=8)
    m = torch.empty(2, 64, 16, 8, dtype=torch.bfloat16, device="meta")
    fnorm.reset_launch_counts()
    with pytest.raises(ValueError):
        fnorm.group_norm_silu(m, torch.ones(64), torch.zeros(64), groups=8)
    with pytest.raises(ValueError):
        fnorm.group_norm_silu(_nchw(x), torch.ones(64), torch.zeros(64), groups=6)
    assert fnorm.launch_counts() == {}


@pytest.mark.parametrize("c", [96, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_channels_last_matches_pallas_interpret(jax_group_norm_silu, dtype, c):
    # The model's layout: the same NHWC numpy array is the JAX function's
    # input and, permuted, the port's channels_last [B, C, H, W] view.
    x, scale, bias = _inputs(b=2, c=c, h=8, w=16, seed=c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_group_norm_silu(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                               groups=32, block_rows=64)
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    assert tx.is_contiguous(memory_format=torch.channels_last)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    got = fnorm.group_norm_silu(tx, ts, tb, groups=32)
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    # What the card runs, in plain versions: per-channel stats, the group
    # fold and mul/add, the apply pass.
    stats = fnorm.group_sums(fnorm.channel_stats_reference(tx), 32)
    mul, add = fnorm.mul_add(stats, (c // 32) * 8 * 16, ts, tb, 1e-5)
    passes = fnorm.apply_reference(tx, mul, add)
    for y in (got, passes):
        y = y.float().permute(0, 2, 3, 1).numpy()
        if dtype == "float32":
            np.testing.assert_allclose(y, want, atol=1e-5, rtol=1e-4)
        else:
            np.testing.assert_allclose(y, want, atol=2 ** -6 * np.abs(want).max(), rtol=0)


def test_channel_stats_do_not_depend_on_the_memory_format():
    x, _, _ = _inputs(c=96, seed=2)
    cl = torch.from_numpy(x).permute(0, 3, 1, 2)
    stats = fnorm.channel_stats_reference(cl)
    assert stats.shape == (2, 2, 96)
    torch.testing.assert_close(stats, fnorm.channel_stats_reference(cl.contiguous()))
    np.testing.assert_allclose(stats[:, 0].numpy(), x.sum(axis=(1, 2)), rtol=1e-5)
    np.testing.assert_allclose(stats[:, 1].numpy(), np.square(x).sum(axis=(1, 2)), rtol=1e-5)
    torch.testing.assert_close(fnorm.group_stats_reference(cl, 32),
                               fnorm.group_sums(stats, 32))
