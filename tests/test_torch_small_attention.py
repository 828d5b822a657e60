"""Row 6 of the TPU kernel table, ``small_attention``, and the sublayer route
that reaches it, against the JAX package.

The port's plain version (what its wrapper computes for CPU tensors) is held
against the Pallas kernel in interpret mode and against the gradient of the
JAX function, on the same numpy inputs. The dispatch that reaches the kernel
-- the sublayer gate (``sublayer_supported`` against the JAX ``supported()``)
and ``core_attention``'s mid band -- is checked on the CPU; the CUDA kernel
itself runs only on a card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances: fp32, 1e-4 abs/rel (fp32 sums in other orders, exp); bf16,
2**-6 * max|ref| (two bf16 rounding steps at the largest magnitude: both
round the normalised weights and the output, but an fp32 sum in another
order can land on the other side of a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu.ops.pallas import fused_attention_block as jfab
from deepl_project_tpu.ops.pallas.small_attention import small_attention as jax_small_attention
from deepl_project_tpu_torch.config import VARIANTS, get_config
from deepl_project_tpu_torch.ops import attention as attn
from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
from deepl_project_tpu_torch.ops.hopper import small_attention as sma

torch.set_num_threads(2)


def _qkv(b=2, n=128, h=2, d=64, seed=0, std=1.5):
    rng = np.random.default_rng(seed)
    return [(std * rng.standard_normal((b, n, h, d))).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_attention_plain_matches_pallas_interpret(dtype):
    q, k, v = _qkv()
    scale = 64 ** -0.5
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_small_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                                          scale, interpret=True).astype(jnp.float32))
    got = sma.small_attention(*(torch.from_numpy(t).to(getattr(torch, dtype))
                                for t in (q, k, v)), scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 ** -6 * np.abs(want).max(), rtol=0)


def test_small_attention_gradient_matches_jax_grad():
    q, k, v = _qkv(n=64, seed=1)
    ct = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    scale = 64 ** -0.5
    want = jax.grad(lambda *a: jnp.sum(jax_small_attention(*a, scale, interpret=True) * ct),
                    argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    got = torch.autograd.grad(sma.small_attention(tq, tk, tv, scale), (tq, tk, tv),
                              torch.from_numpy(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_small_attention_function_backward_is_the_plain_vjp(monkeypatch):
    # The autograd Function around the forward-only kernel, driven on the CPU
    # with the plain forward in place of the launch: its gradients equal
    # autograd through the plain version (the JAX package's _make_op).
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in _qkv(n=64, seed=3))
    monkeypatch.setattr(sma, "_kernel", lambda *a: sma.small_attention_reference(
        *(t.detach() for t in a[:3]), a[3]))
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal(q.shape).astype(np.float32))
    out = sma._SmallAttention.apply(q, k, v, 0.125)
    got = torch.autograd.grad(out, (q, k, v), ct)
    want = torch.autograd.grad(sma.small_attention_reference(q, k, v, 0.125), (q, k, v), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_small_attention_refuses_long_axes_and_off_cpu_tensors():
    q = torch.zeros(1, 2048, 1, 64)
    with pytest.raises(ValueError, match="N <= 1024"):
        sma.small_attention(q, q, q, 0.125)
    # A tensor off the CPU must reach the kernel or raise (meta stands in
    # for a card: not CUDA, so the wrapper refuses it).
    m = torch.empty(1, 1024, 2, 64, dtype=torch.bfloat16, device="meta")
    sma.reset_launch_counts()
    with pytest.raises(ValueError):
        sma.small_attention(m, m, m, 0.125)
    assert sma.launch_counts() == {}


@pytest.mark.parametrize("n", [256, 512, 576, 768, 1024, 2048])
def test_sublayer_gate_takes_the_jax_route(n):
    # The port's gate against the JAX supported() on a grid of (N, C), where
    # the port's kernels take the shape: the whole-sublayer kernels exactly
    # where the JAX package takes its sublayer kernel.
    bf = torch.bfloat16
    for c in (384, 768, 1024, 1280, 1536, 2048, 2560):
        want = jfab.supported(n, c, 64, jnp.bfloat16)
        assert fab.sublayer_supported(n, c, 64, bf) == want, (n, c)
        if want:
            assert fab.sublayer_kernels_supported(n, c, 64, bf)
    # The large f16d32 shapes: 256px stages 3-4 keep the sublayer (stage 3
    # with a head group of 2); 512px stage 4 leaves it.
    assert fab._pick_group(12, 64, 1024, 768) == 2
    assert fab.sublayer_supported(256, 1536, 64, bf)
    assert not fab.sublayer_supported(1024, 1536, 64, bf)
    assert fab.kernel_supported(1024, 1536, 64, bf)  # ln_qkv_rope still runs


def test_core_dispatch_mid_band_takes_small_attention():
    # core_impl mirrors the JAX core_attention: the mid band at N=1024 is the
    # whole-head kernel in inference only, and only where the kernels run.
    assert attn.core_impl(1024, "auto", True) == "pallas_small"
    assert attn.core_impl(1024, "auto", False) == "xla"
    assert attn.core_impl(1024, "auto_train", True) == "xla"
    assert attn.core_impl(2048, "auto", True) == "pallas"
    assert attn.core_impl(256, "auto", True) == "xla"
    assert attn.core_impl(4096, "auto", True) == "pallas"
    assert attn.core_impl(1024, "pallas_small", False) == "pallas_small"
    q, k, v = (torch.from_numpy(t) for t in _qkv(n=64, seed=5))
    torch.testing.assert_close(attn.core_attention(q, k, v, 0.125, "pallas_small"),
                               attn.xla_attention(q, k, v, 0.125), atol=1e-5, rtol=1e-5)


def test_attention_module_accepts_pallas_small():
    # The explicit impl the JAX core_attention accepts: on the CPU the
    # composable path with the plain whole-head core equals the plain core.
    torch.manual_seed(0)
    m = attn.AttentionRoPE(64, head_dim=16, impl="pallas_small")
    x = torch.randn(2, 64, 8, 8)
    ref = attn.AttentionRoPE(64, head_dim=16, impl="xla")
    ref.load_state_dict(m.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(m(x), ref(x), atol=1e-5, rtol=1e-5)


def test_kernel_limits_as_predicates():
    # One predicate per kernel, the one its wrapper checks before a launch.
    bf = torch.bfloat16
    assert fab.proj_supported(128, bf) and fab.proj_supported(1536, bf)
    assert not fab.proj_supported(320, bf)  # C % 128
    assert not fab.proj_supported(768, torch.float32)
    assert sma.small_attention_supported(64, 1, 64)
    assert sma.small_attention_supported(960, 24, 64)
    assert sma.small_attention_supported(1024, 24, 64)
    assert not sma.small_attention_supported(1088, 24, 64)  # N > 1024
    assert not sma.small_attention_supported(1000, 24, 64)  # N % 64
    assert not sma.small_attention_supported(1024, 24, 32)  # head_dim 64 only


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dispatch_sends_the_kernels_only_shapes_they_take(variant):
    # Pure Python on the config: every transformer stage's (N, C) at 256,
    # 512 and 1024px through the gates that AttentionRoPE(impl='auto') and
    # core_attention apply on the card (bf16, head_dim 64). Where they take
    # the whole sublayer, proj_bias_gemm's predicate must hold; where the
    # core takes the whole-head kernel, small_attention's must.
    cfg = get_config(variant)
    bf, hd = torch.bfloat16, cfg.head_dim
    reached = []
    for res in (256, 512, 1024):
        for i in range(cfg.num_cnn_stages, cfg.num_stages):
            n, c = (res >> i) ** 2, cfg.base_dims[i]
            if fab.sublayer_supported(n, c, hd, bf):
                assert fab.proj_supported(c, bf), (res, n, c)
                reached.append(("proj_bias_gemm", res, n, c))
                continue
            # flash_supported() of the card's bf16 [B, N, heads, 64] tensors.
            kernels_ok = hd == fla.HEAD_DIM and n % fla.BLOCK == 0
            if attn.core_impl(n, "auto", kernels_ok) == "pallas_small":
                assert sma.small_attention_supported(n, c // hd, hd), (res, n, c)
                reached.append(("small_attention", res, n, c))
    if variant == "large_f16d32":  # chip_smoke.py's launch tables
        assert reached == [("proj_bias_gemm", 256, 1024, 768),
                           ("proj_bias_gemm", 256, 256, 1536),
                           ("small_attention", 512, 1024, 1536)]
