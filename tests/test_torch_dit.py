"""The port's latent DiT (``deepl_project_tpu_torch/models/dit.py``) against
the JAX package's on the CPU, on the same weights (``tests/dit_parity.py``).

- The converter on the flat and the scan layouts, loaded with strict=True.
- The forward: fp32 with the LightningDiT gates on, with ``--plain_dit``'s
  (learned ``pos_embed``, GELU, LayerNorm), and bf16 compute.
- ``init_dit_weights``: exact zeros from the zero-init head, and each
  parameter's spread against the JAX initializers'.
- The same weights at 8x8 and 16x16 grids, ``timestep_embedding`` at an odd
  dim, the null class, the label-dropout share, and the refusals.

Tolerances: fp32 2e-5 x max|v| (measured ~2.5e-6: sums in other orders
through two blocks). bf16: the packages round at different places (Flax
rounds a Dense's product, then adds the bias in bf16; XLA may keep an
elementwise chain in fp32), so the port's bf16 output is held to JAX's
within 2^-5 x max|v| (four bf16 steps; measured ~1e-2) and, against the
fp32 forward on the same weights, to mean and max errors within 1.5x and
2x JAX's own bf16 errors (``chip_smoke.py``'s MODEL_MEAN_RATIO /
MODEL_MAX_RATIO rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu.models import DiT as JaxDiT
from deepl_project_tpu.models import init_dit_params
from deepl_project_tpu.models.dit import timestep_embedding as jax_timestep_embedding
from deepl_project_tpu_torch.models import DiT, create_dit
from deepl_project_tpu_torch.models.dit import LabelEmbedder, timestep_embedding
from deepl_project_tpu_torch.utils.convert import (dit_params_to_torch_state_dict,
                                                   load_jax_dit_params)

from dit_parity import (inputs, jax_cfg, jax_forward, make_pair, port_cfg, random_params,
                        torch_args)

torch.set_num_threads(2)
FP32_RTOL = 2e-5


def _forward(pm, z, t, y):
    with torch.no_grad():
        return pm(*torch_args(z, t, y)).numpy()


def test_torch_dit_converter_flat_and_scan_layouts():
    jm, flat, pm = make_pair()
    sd = dit_params_to_torch_state_dict(flat)
    assert set(sd) == set(pm.state_dict())
    assert sd["patch_embed.weight"].shape == (64, 4, 2, 2)            # HWIO -> OIHW
    assert sd["block1.qkv.weight"].shape == (192, 64)                 # [in, out] -> [out, in]
    assert sd["y_embed.embedding"].shape == (11, 64)                  # the null class row
    np.testing.assert_array_equal(sd["block0.proj.weight"], flat["block0"]["proj"]["kernel"].T)

    # The scan layout (blocks/block with a leading depth axis) unstacks into
    # block{i}: the port runs what the JAX scan model runs.
    scan_model = JaxDiT(jax_cfg(scan_blocks=True))
    scanned = random_params(scan_model, seed=3)
    assert set(scanned) >= {"blocks"} and not any(k.startswith("block0") for k in scanned)
    pm_scan = DiT(port_cfg(jax_cfg()), 8)
    load_jax_dit_params(pm_scan, scanned)
    z, t, y = inputs()
    want = np.asarray(jax_forward(scan_model)(scanned, z, t, y))
    got = _forward(pm_scan, z, t, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_RTOL * np.abs(want).max())
    torch.testing.assert_close(pm_scan.block1.ffn_down.weight,
                               torch.from_numpy(scanned["blocks"]["block"]["ffn_down"]
                                                ["kernel"][1].T.copy()))


@pytest.mark.parametrize("case", ["fp32", "fp32_plain_dit", "bf16"])
def test_torch_dit_forward_matches_jax(case):
    kw = dict(use_rmsnorm=False, use_swiglu=False, use_rope=False) if "plain" in case else {}
    jm, params, pm = make_pair("bfloat16" if case == "bf16" else "float32", **kw)
    if "plain" in case:
        assert "pos_embed" in dict(pm.named_parameters())
        assert not hasattr(pm.block0, "ffn_gate")
    z, t, y = inputs()
    want = np.asarray(jax_forward(jm)(params, z, t, y))
    got = _forward(pm, z, t, y)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 8, 8, 4)
    err, top = np.abs(got - want), np.abs(want).max()
    if case != "bf16":
        assert err.max() <= FP32_RTOL * top, (err.max(), top)
        return
    assert err.max() <= 2 ** -5 * top, (err.max(), top)
    # Both bf16 computations against the fp32 one on the same weights: the
    # port's as close to it as JAX's own.
    exact = np.asarray(jax_forward(JaxDiT(jax_cfg()))(params, z, t, y))
    ours, theirs = np.abs(got - exact), np.abs(want - exact)
    assert ours.mean() <= 1.5 * theirs.mean(), (ours.mean(), theirs.mean())
    assert ours.max() <= 2.0 * theirs.max(), (ours.max(), theirs.max())


def test_torch_dit_zero_init_head_and_init_distributions():
    """init_dit_weights: the zero head gives exactly 0 (adaLN-Zero); each
    parameter's spread matches the JAX init's at the micro width (4096
    draws or more: std within 10%, the truncation point within 5%; zeros
    exactly where JAX has zeros)."""
    cfg = jax_cfg()
    model = create_dit(port_cfg(cfg), 8, device="cpu", seed=0)
    z, t, y = inputs()
    v = _forward(model, z, t, y)
    assert np.array_equal(v, np.zeros_like(v))

    jm = JaxDiT(cfg)
    jparams = jax.jit(lambda k: init_dit_params(jm, k, grid=8))(jax.random.PRNGKey(0))
    want = dit_params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    for name, w in want.items():
        if not w.any():
            assert not got[name].any(), name
        elif w.size >= 4096:
            assert abs(got[name].std() / w.std() - 1) < 0.1, (name, got[name].std(), w.std())
            # Both cut at two standard deviations of the untruncated normal.
            cut = np.abs(got[name]).max() / np.abs(w).max()
            assert abs(cut - 1) < 0.05, (name, cut)


def test_torch_dit_same_weights_at_two_grids():
    """RoPE on the patch grid: weights built at 8x8 run at 16x16 (N=64), as
    in JAX."""
    jm, params, pm = make_pair(grid=8)
    fwd = jax_forward(jm)
    for grid in (8, 16):
        z, t, y = inputs(grid=grid)
        want = np.asarray(fwd(params, z, t, y))
        got = _forward(pm, z, t, y)
        assert got.shape == (2, grid, grid, 4)
        assert np.abs(got - want).max() <= FP32_RTOL * np.abs(want).max()


@pytest.mark.parametrize("dim", [7, 256])
def test_torch_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 0.013, 0.5, 1.0], np.float32)
    want = np.asarray(jax_timestep_embedding(jnp.asarray(t), dim))
    got = timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == (4, dim) and got.dtype == np.float32
    if dim % 2:
        assert not got[:, -1].any()
    # Angles up to 1000 rad: a 1-ulp difference in the fp32 argument moves
    # cos/sin by ~6e-5.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_torch_dit_null_class_labels():
    """Labels at num_classes read the trained null row (the CFG branch)."""
    jm, params, pm = make_pair()
    z, t, _ = inputs()
    y = np.full(2, 10, np.int32)
    want = np.asarray(jax_forward(jm)(params, z, t, y))
    assert np.abs(_forward(pm, z, t, y) - want).max() <= FP32_RTOL * np.abs(want).max()
    with torch.no_grad():
        row = pm.y_embed(torch.tensor([10]))
    np.testing.assert_array_equal(row.numpy(), params["y_embed"]["embedding"][10:11])


def test_torch_label_dropout_share():
    """deterministic=False drops a share ~class_dropout of the labels to the
    null class, from the caller's generator (the same seed, the same drops);
    deterministic=True drops none."""
    emb = LabelEmbedder(10, 4, dropout=0.1)
    with torch.no_grad():
        emb.embedding.copy_(torch.arange(11.0)[:, None].expand(11, 4))
        labels = torch.arange(40_000) % 10
        out = emb(labels, deterministic=False,
                  generator=torch.Generator().manual_seed(0))[:, 0]
        again = emb(labels, deterministic=False,
                    generator=torch.Generator().manual_seed(0))[:, 0]
        kept = emb(labels)[:, 0]
    dropped = (out == 10).float().mean().item()
    # Binomial(40000, 0.1): std 0.0015; 5 sigma.
    assert abs(dropped - 0.1) < 0.0075, dropped
    assert torch.equal(out, again)
    assert torch.equal(out[out != 10], labels[out != 10].float())
    assert torch.equal(kept, labels.float())
    always = LabelEmbedder(10, 4, dropout=1.0)
    always.embedding.data.copy_(emb.embedding.data)
    with torch.no_grad():
        assert (always(labels[:100], deterministic=False)[:, 0] == 10).all()


def test_torch_dit_refuses_scan_blocks_and_pipeline_axis():
    """scan_blocks and pipeline_axis are accepted: each holds the blocks in
    the stacked layout (``blocks.block.<path>`` [depth, ...]); a model
    holding a single stage's slices refuses to run outside its pipe group."""
    cfg = port_cfg(jax_cfg())
    for kw in ({"scan_blocks": True}, {"pipeline_axis": "pipe"}):
        pm = DiT(dataclasses.replace(cfg, **kw), 8)
        assert pm.state_dict()["blocks.block.qkv.weight"].shape == (2, 192, 64)
        assert not any(k.startswith("block0") for k in pm.state_dict())
    staged = DiT(dataclasses.replace(cfg, pipeline_axis="pipe"), 8)
    staged.blocks.hold_slices(range(0, 1))  # what PipelinePlacement.shard leaves stage 0
    with pytest.raises(RuntimeError, match="run it under its pipe group"):
        staged(*torch_args(*inputs()))
