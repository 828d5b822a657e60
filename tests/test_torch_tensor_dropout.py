"""Dropout under tensor parallelism in the port, against one process and
the JAX package, on gloo CPU ranks (harness: tests/torch_parallel_jobs.py;
one pool of rank processes for the file).

The JAX modules apply ``nn.Dropout`` to the sublayer's output, after the
output projection, under any sharding: one mask over the replicated
output. The port's modules apply ``ops.layers.dropout`` there, after the
model group's reduce, with a mask every rank of the group draws alike
(group rank 0's seed broadcast) and that one process draws at the same
global seed and shape.

- AttentionRoPE(32, 16 a head) and ConvFFN(32) at dropout 0.25, model 2
  (one head, a quarter of the hidden channels a rank): the ranks'
  train-mode outputs identical; their masks equal one process's at the same
  seed; the dropped share within 0.02 of p; every entry either 0 or the
  rank's deterministic output times 1 / (1 - p) (rtol 1e-6), as JAX's own
  train-mode output is of its deterministic one; that deterministic output
  within 2e-4 of the JAX module's on the converted weights
  (tests/test_torch_ops.py's bar); the train-mode output within 1e-5 of
  one process's (the sums of two head shards in another order).
- The micro TransVAE at dropout 0.25 under 'tensor' at model 2: the ranks'
  reconstructions identical, each of its 8 masks equal to one process's,
  the dropped share within 0.02 of p, the reconstruction within 1e-5 of
  one process's (relative to its largest), the attention on the local
  heads' composable route (no sublayer kernel while dropout is live).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_jobs as J
from deepl_project_tpu.ops import attention as jattn
from deepl_project_tpu.ops import ffn as jffn
from deepl_project_tpu_torch.utils.convert import params_to_torch_state_dict

torch.set_num_threads(1)
P_DROP = 0.25
SEED = 11


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


def _jax_module(kind: str):
    """The JAX module at dropout P_DROP, its params (norm affines and biases
    moved off their init) as a port state_dict, the NHWC input, its
    deterministic output and one train-mode output."""
    jmod = (jattn.AttentionRoPE(32, 16, dropout=P_DROP, impl="xla", dtype=jnp.float32)
            if kind == "attention" else jffn.ConvFFN(32, dropout=P_DROP, dtype=jnp.float32))
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 32)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                      if p[-1].key in ("scale", "bias") else v), params)
    det = np.asarray(jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, x))
    drop = np.asarray(jax.jit(lambda p, x, key: jmod.apply(
        {"params": p}, x, deterministic=False, rngs={"dropout": key}))(
            params, x, jax.random.PRNGKey(2)))
    return params_to_torch_state_dict(params), x, det, drop


@pytest.mark.parametrize("kind", ["attention", "conv_ffn"])
def test_tensor_parallel_dropout_module_matches_one_process_and_jax(pool, tmp_path, kind):
    sd, x, jdet, jdrop = _jax_module(kind)
    # JAX's own: one mask on the module's output, kept entries rescaled.
    kept = jdrop != 0
    assert abs(1 - kept.mean() - P_DROP) < 0.02
    np.testing.assert_allclose(jdrop[kept], jdet[kept] / (1 - P_DROP), rtol=1e-6)

    one = J.dropout_module(kind, sd, x, P_DROP, SEED, None)
    got = pool.run(J.dropout_module, 2, tmp_path, kind, sd, x, P_DROP, SEED, 2)
    assert [r["split"] for r in got] == [True, True] and not one["split"]
    assert torch.equal(got[0]["out"], got[1]["out"])
    for r in got:
        assert len(r["masks"]) == len(one["masks"]) == 1
        assert torch.equal(r["masks"][0], one["masks"][0])
        keep = r["masks"][0]
        assert keep.shape == r["out"].shape
        assert abs(1 - keep.float().mean().item() - P_DROP) < 0.02
        assert (r["out"][~keep] == 0).all()
        torch.testing.assert_close(r["out"][keep], r["det"][keep] / (1 - P_DROP),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(r["det_nhwc"].numpy(), jdet,
                                   rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(r["out"], one["out"], rtol=0, atol=1e-5)


def test_tensor_parallel_dropout_model_matches_one_process(pool, tmp_path):
    data = J.batches(1, 2)
    one = J.dropout_model(None, data, P_DROP, SEED)
    got = pool.run(J.dropout_model, 2, tmp_path, 2, data, P_DROP, SEED)
    assert torch.equal(got[0]["recon"], got[1]["recon"])
    # Two transformer stages of one block a side: an attention and an FFN
    # mask a block.
    assert len(one["masks"]) == 2 * 2 * 2
    for r in got:
        assert len(r["masks"]) == len(one["masks"])
        assert all(torch.equal(a, b) for a, b in zip(r["masks"], one["masks"]))
        kept = torch.cat([m.flatten() for m in r["masks"]]).float().mean().item()
        assert abs(1 - kept - P_DROP) < 0.02
        top = one["recon"].abs().max().item()
        torch.testing.assert_close(r["recon"], one["recon"], rtol=0, atol=1e-5 * top)
        assert r["routes"].get("local_heads", 0) == 4 and not r["routes"].get("sublayer")
