"""The port's ring attention, halo exchange and context forms of the model's
ops on 2 and 4 gloo ranks, against the JAX package and the single-process
port, on the CPU (rank jobs: tests/torch_context_jobs.py, one pool of rank
processes for the file).

- The ring (``parallel.ring_attention``: plain partials on CPU tensors, the
  backward's dq, dk and dv from the merged o and lse) against the JAX
  package's ``sequence_parallel_attention`` (its 8-device ring) and
  ``xla_attention`` on the same numpy q, k, v, with JAX's own bars: fp32
  2e-5, bf16 5e-2; the gradients against ``jax.vjp`` of ``xla_attention``,
  fp32 1e-4. ``ring_attention_reference`` (the JAX ring's math) too.
- ``exchange_rows`` is the adjoint of its backward: <halo(x), g> =
  <x, halo^T(g)> in float64.
- ``context_conv2d`` at stride 1 and 2, a 1x1 conv (no halo), the depthwise
  ConvFFN conv, the fused up-conv (and the literal up path), the Downsample
  (fused and literal DC path), the 2x2 pool of LPIPS, and GroupNorm
  (moments summed over the group) each equal the whole map's op sliced to
  the rank's rows, with their input gradients (fp32, 1e-5 of the largest);
  the RoPE table of a rank's rows equals the global table's rows exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_context_jobs as C
import torch_parallel_jobs as J
from deepl_project_tpu.ops.attention import xla_attention as jax_xla_attention
from deepl_project_tpu.parallel import create_mesh as jax_create_mesh
from deepl_project_tpu.parallel.ring_attention import (
    sequence_parallel_attention as jax_sequence_parallel_attention)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_in_fp32(pool, tmp_path, world):
    """The JAX test's shapes (2, 64, 2 heads, 16): the ring's output, its
    plain JAX-math version and the gradients."""
    q, k, v, do = _inputs((2, 64, 2, 16), 0)
    scale = 16 ** -0.5
    want, vjp = jax.vjp(lambda a, b, c: jax_xla_attention(a, b, c, scale), q, k, v)
    jring = jax_sequence_parallel_attention(jax_create_mesh(), q, k, v, scale, axis="data")
    got = pool.run(C.ring, world, tmp_path, q, k, v, do, scale, "float32")[0]
    for out in (got["out"], got["ref"]):
        np.testing.assert_allclose(_np(out), np.asarray(want), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(out), np.asarray(jring), rtol=2e-5, atol=2e-5)
    for g, w in zip(got["grads"], vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    assert got["steps"] == {"forward": world, "backward": world}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_in_bf16(pool, tmp_path, world):
    """bf16 q, k, v (1, 128, 1 head, 32): the output against JAX's fp32
    attention of the same values (JAX's bf16 test and bar)."""
    q, k, v, do = (np.asarray(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32))
                   for t in _inputs((1, 128, 1, 32), 1))
    scale = 32 ** -0.5
    want = np.asarray(jax_xla_attention(q, k, v, scale))
    jring = jax_sequence_parallel_attention(jax_create_mesh(), *(jnp.asarray(t, jnp.bfloat16)
                                                                for t in (q, k, v)),
                                            scale, axis="data")
    got = pool.run(C.ring, world, tmp_path, q, k, v, do, scale, "bfloat16")[0]
    assert got["out"].dtype == torch.bfloat16
    for out in (got["out"], got["ref"]):
        np.testing.assert_allclose(_np(out), want, rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(_np(out), _np(jring), rtol=5e-2, atol=5e-2)


def test_sequence_parallel_attention_takes_whole_tensors(pool, tmp_path):
    q, k, v, _ = _inputs((2, 64, 2, 16), 2)
    scale = 16 ** -0.5
    want = jax_sequence_parallel_attention(jax_create_mesh(), q, k, v, scale, axis="data")
    for got in pool.run(C.sequence_parallel, 4, tmp_path, q, k, v, scale):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world,top,bottom", [(2, 1, 1), (4, 1, 1), (4, 1, 0), (2, 2, 2)])
def test_halo_exchange_is_the_adjoint_of_its_backward(pool, tmp_path, world, top, bottom):
    rng = np.random.default_rng(3)
    h = 8
    x = rng.standard_normal((2, 3, h, 5))
    lhs, rhs = pool.run(C.halo_adjoint, world, tmp_path, x, top, bottom, 3)[0]
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("world", [2, 4])
def test_convs_equal_the_whole_map_sliced(pool, tmp_path, world):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 16, 12)).astype(np.float32)
    up_x = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
    for r in pool.run(C.convs, world, tmp_path, x, up_x, 5):
        for name, (err, top, gerr, gtop) in r.items():
            assert err <= 1e-5 * top and gerr <= 1e-5 * gtop, (name, err, top, gerr, gtop)


@pytest.mark.parametrize("world", [2, 4])
def test_group_norm_and_rope_under_context(pool, tmp_path, world):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 8, 16, 4)) * 3 + 1).astype(np.float32)
    q = rng.standard_normal((2, 16 * 6, 2, 8)).astype(np.float32)
    for r in pool.run(C.norm_and_rope, world, tmp_path, x, q):
        assert r["norm"] <= 1e-5 and r["norm_grad"] <= 1e-5 and r["rope"] == 0.0, r
