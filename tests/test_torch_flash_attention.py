"""The port's flash attention (rows 3-5 of the TPU kernel table) against the
JAX package's ``flash_attention``, run in interpret mode on the CPU.

The port's plain forward (o and logsumexp) and plain backward (dq, dk, dv)
are what its wrappers run for CPU tensors and what ``chip_smoke.py`` holds
the CUDA kernels to on the card; here they are held to the Pallas kernels
(``_flash_forward`` and ``jax.vjp`` through the custom VJP) on the same
seeded numpy inputs, N=256 with 128-token blocks, 3 heads (both also at
N=320 with 64-token blocks).

Tolerances: fp32, 1e-4 x max|ref| (online vs whole-row softmax, other
summation orders); bf16, 2**-6 x max|ref| (two bf16 rounding steps at the
largest magnitude: both round p and ds at the same places, but an fp32 sum
in another order can land on the other side of a rounding boundary).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu.ops.pallas import flash_attention as jfa
from deepl_project_tpu_torch.ops import attention as tattn
from deepl_project_tpu_torch.ops.hopper import flash_attention as fla

torch.set_num_threads(2)
B, N, H, D, BLOCK = 1, 256, 3, 64, 128
SCALE = D ** -0.5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = jfa.pl.pallas_call
    monkeypatch.setattr(jfa.pl, "pallas_call", functools.partial(orig, interpret=True))


def _inputs(seed, dtype, n=N):
    rng = np.random.default_rng(seed)
    arrs = [(1.5 * rng.standard_normal((B, n, H, D))).astype(np.float32) for _ in range(4)]
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrs]
    return arrs


def _to(arrs, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrs], [torch.from_numpy(a).to(td) for a in arrs])


def _tol(dtype):
    return 2 ** -6 if dtype == "bfloat16" else 1e-4


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(dtype) * np.abs(want).max())


def _fold(x):  # [B, N, h, d] -> [B*h, N, d], the JAX kernel's layout
    return x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], D)


@pytest.mark.parametrize("dtype,n,block", [
    ("float32", N, BLOCK), ("bfloat16", N, BLOCK), ("float32", 320, 64), ("bfloat16", 320, 64)],
    ids=["float32", "bfloat16", "float32-320-64", "bfloat16-320-64"])
def test_plain_forward_and_lse_match_pallas(dtype, n, block):
    # N = 320 with 64-token blocks: five 64-key tiles, where the card's
    # forward (128-key tiles) masks the zero-filled half of its last tile.
    (jq, jk, jv, _), (q, k, v, _) = _to(_inputs(0, dtype, n), dtype)
    out, lse = jfa._flash_forward(_fold(jq), _fold(jk), _fold(jv), SCALE, block, block)
    o, tlse = fla.flash_forward(q, k, v, SCALE)  # CPU: the plain forward
    assert o.dtype == q.dtype and tlse.dtype == torch.float32
    _close(o, out.reshape(B, H, n, D).transpose(0, 2, 1, 3), dtype)
    _close(tlse, lse.reshape(B, H, n), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_grad(dtype):
    (jq, jk, jv, jg), (q, k, v, g) = _to(_inputs(1, dtype), dtype)
    fn = functools.partial(jfa.flash_attention, scale=SCALE, block_q=BLOCK, block_k=BLOCK)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    want = vjp(jg)
    o, lse = fla.flash_forward(q, k, v, SCALE)
    got = fla.flash_backward(q, k, v, o, lse, g, SCALE)
    for gt, w in zip(got, want):
        assert gt.dtype == q.dtype
        _close(gt, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_grad_on_odd_tile_count(dtype):
    # N = 320 with 64-token blocks: five 64-key tiles, a shape the gate
    # admits that is not a multiple of 128 (the card's backward takes keys
    # 128 at a time and ends on a half tile there).
    n, block = 320, 64
    (jq, jk, jv, jg), (q, k, v, g) = _to(_inputs(3, dtype, n), dtype)
    fn = functools.partial(jfa.flash_attention, scale=SCALE, block_q=block, block_k=block)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    want = vjp(jg)
    o, lse = fla.flash_forward(q, k, v, SCALE)
    got = fla.flash_backward(q, k, v, o, lse, g, SCALE)
    for gt, w in zip(got, want):
        assert gt.shape == (B, n, H, D) and gt.dtype == q.dtype
        _close(gt, w, dtype)


def test_function_on_cpu_matches_autograd_of_plain_core():
    # The autograd Function (plain forward and backward on the CPU) against
    # autograd through the port's plain attention core, fp32 (1e-5).
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, "float32"))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fla.flash_attention(*leaves, SCALE)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.xla_attention(*ref_leaves, SCALE)
    want = torch.autograd.grad(ref, ref_leaves, g)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_dispatch_bands():
    # The JAX bands; the flash kernels only for CUDA bf16 head_dim-64 inputs,
    # so CPU tensors take the plain core, as the JAX package off a TPU.
    q = torch.zeros(1, 4096, 2, 64, dtype=torch.bfloat16)
    assert not fla.flash_supported(q)
    assert tattn._PALLAS_MIN_TOKENS_TRAIN == 4096 and tattn._XLA_FULL_SOFTMAX_MAX_TOKENS == 2048
    assert set(tattn.IMPLS) >= {"auto", "auto_train", "xla", "pallas"}
    with pytest.raises(NotImplementedError):
        tattn.AttentionRoPE(64, impl="fused")
