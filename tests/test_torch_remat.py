"""Gradient checkpointing and dropout in the port, against the JAX package.

- Grads of a micro TransVAE under each remat policy ('none', 'dots',
  'dots_all', 'conv_dots', and 'dots' with ``remat_resample``) against the
  port without remat and against JAX's ``enable_gradient_checkpointing``
  model, on the same weights and images.
- The bytes a forward leaves alive for the backward, in JAX's documented
  order: no remat > conv_dots >= dots_all >= dots >= none. They are the
  storages made during the forward that are still alive after it (the
  autograd graph's saved tensors, each checkpoint's inputs and the outputs
  its policy keeps), found through a dispatch mode and weak references:
  ``saved_tensors_hooks`` cannot count them, as a checkpoint installs its own
  hooks and only the innermost pair sees a save.
- Under remat the flash core's forward runs twice per block (the forward,
  the recompute) and its backward once.
- Dropout: off (``deterministic=True``, the default) it changes nothing;
  on, it zeroes about p of the outputs and scales the rest by 1/(1-p); the
  training step never turns it on.

Tolerances: remat against no remat 1e-6 x the largest gradient (the same
fp32 arithmetic recomputed; measured 0); against JAX the micro model's
(loss 1e-5 relative, gradients 1e-4 x the largest gradient, as
tests/test_torch_training.py).
"""

import jax
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.losses.vae_loss import transvae_loss as jax_transvae_loss
from deepl_project_tpu.models.transvae import (
    enable_gradient_checkpointing as jax_enable_gradient_checkpointing)
from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.models import TransVAE, enable_gradient_checkpointing, init_weights
from deepl_project_tpu_torch.ops import AttentionRoPE, ConvFFN
from deepl_project_tpu_torch.ops.blocks import resolve_remat_policy
from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
from deepl_project_tpu_torch.training.train_step import compute_grads
from deepl_project_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(2)
VARIANT = "tiny_f8d16"
# Three stages (two CNN, one transformer) without the DC shortcut path: the
# JAX gradient's trace and compile stay a few seconds.
MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4,
             head_dim=16, dtype="float32", attention_impl="auto_train", use_dc_path=False)
WEIGHTS = dict(l1=1.0, lpips=0.0, kl=1e-2, vf=0.0, gan=0.0)
# id -> (remat_policy, remat_resample)
POLICIES = {"none": ("none", False), "dots": ("dots", False),
            "dots_all": ("dots_all", False), "conv_dots": ("conv_dots", False),
            "dots+resample": ("dots", True)}


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def micro():
    """(port model without remat, JAX params, batch) on shared weights."""
    cfg = get_config(VARIANT, **MICRO)
    src = TransVAE(cfg, device="cpu")
    init_weights(src, torch.Generator().manual_seed(0))
    params = torch_state_dict_to_params({k: v.numpy() for k, v in src.state_dict().items()},
                                        jax_get_config(VARIANT, **MICRO))
    port = TransVAE(cfg, device="cpu")
    load_jax_params(port, params)
    batch = np.random.default_rng(4).random((2, 16, 16, 3), dtype=np.float32)
    return port, params, batch


def _remat(model, policy, resample):
    out = enable_gradient_checkpointing(model, policy)
    if resample:
        with torch.device("meta"):
            out = TransVAE(out.config.replace(remat_resample=True))
        out.load_state_dict(model.state_dict(keep_vars=True), assign=True)
    return out


@pytest.mark.parametrize("case", list(POLICIES))
def test_remat_grads_match_no_remat_and_jax(micro, case):
    port, params, batch = micro
    policy, resample = POLICIES[case]
    remat = _remat(port, policy, resample)
    assert remat.config.remat and remat.config.remat_policy == policy
    assert remat.conv_mu.weight is port.conv_mu.weight  # the same parameters
    weights = LossWeights(**WEIGHTS)
    ref, mref = compute_grads(port, torch.from_numpy(batch), weights, sample=False)
    got, mgot = compute_grads(remat, torch.from_numpy(batch), weights, sample=False)
    top = max(float(g.abs().max()) for g in ref)
    for a, b in zip(got, ref):
        _close(a.numpy(), b.numpy(), rtol=0, atol=1e-6 * top)
    assert float(mgot["total"]) == float(mref["total"])

    jcfg = jax_get_config(VARIANT, **MICRO)
    jm = jax_enable_gradient_checkpointing(JaxTransVAE(jcfg), policy)
    if resample:
        jm = JaxTransVAE(jm.config.replace(remat_resample=True))

    def loss_fn(p):
        recon, mu, logvar = jm.apply({"params": p}, batch, sample=False)
        return jax_transvae_loss(recon, batch, mu, logvar, JaxLossWeights(**WEIGHTS))["total"]

    loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = jax_to_sd(jax.tree_util.tree_map(np.asarray, jgrads), None)
    _close(float(mgot["total"]), float(loss), rtol=1e-5)
    jtop = max(np.abs(w).max() for w in want.values())
    for (name, _), g in zip(remat.named_parameters(), got):
        _close(g.numpy(), want[name], rtol=0, atol=1e-4 * jtop)


def test_unknown_remat_policy_raises():
    assert resolve_remat_policy("none") is None and resolve_remat_policy(None) is None
    with pytest.raises(ValueError, match="Unknown remat policy 'everything'"):
        resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="Unknown remat policy"):
        TransVAE(get_config(VARIANT, **MICRO, remat=True, remat_policy="everything"),
                 device="meta")


class _Made(TorchDispatchMode):
    """Weak references to the storage of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.refs.append((StorageWeakRef(s), s.nbytes()))
        return out


def _bytes_kept(model, x) -> int:
    """Bytes of the storages made in the forward and alive after it, while
    the loss (and so the graph) is kept."""
    made = _Made()
    with made:
        recon, mu, logvar = model(x)
        loss = recon.float().square().mean() + mu.float().square().mean()
    alive = {ref.cdata: n for ref, n in made.refs if not ref.expired()}
    loss.backward()  # the graph is whole: the backward runs
    return sum(alive.values())


def test_remat_keeps_fewer_bytes_in_the_jax_order(micro):
    port = micro[0]
    x = torch.from_numpy(micro[2]).permute(0, 3, 1, 2)
    kept = {"no remat": _bytes_kept(port, x)}
    for case in ("conv_dots", "dots_all", "dots", "none"):
        kept[case] = _bytes_kept(_remat(port, *POLICIES[case]), x)
    port.zero_grad(set_to_none=True)
    assert (kept["no remat"] > kept["conv_dots"] >= kept["dots_all"] >= kept["dots"]
            >= kept["none"]), kept
    # The plain attention core's batched products (dots_all) and the convs
    # (conv_dots) are kept on top of the linear layers' outputs.
    assert kept["conv_dots"] > kept["dots_all"] > kept["dots"] > kept["none"], kept


def test_remat_recomputes_the_flash_forward(micro, monkeypatch):
    # attention_impl='pallas' takes the flash function at every transformer
    # block; on the CPU it runs its plain forward and backward.
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = fla.flash_forward_reference, fla.flash_backward_reference

    def count_fwd(*a, **k):
        calls["forward"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["backward"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(fla, "flash_forward_reference", count_fwd)
    monkeypatch.setattr(fla, "flash_backward_reference", count_bwd)
    cfg = get_config(VARIANT, **{**MICRO, "attention_impl": "pallas"})
    model = TransVAE(cfg, device="cpu")
    model.load_state_dict(micro[0].state_dict())
    blocks = 2 * sum(cfg.depths[cfg.num_cnn_stages:])  # encoder and decoder
    x = torch.from_numpy(micro[2]).permute(0, 3, 1, 2)
    for remat, forwards in ((None, blocks), ("dots", 2 * blocks), ("none", 2 * blocks)):
        m = model if remat is None else enable_gradient_checkpointing(model, remat)
        calls.update(forward=0, backward=0)
        recon = m(x)[0]
        assert calls == {"forward": blocks, "backward": 0}
        recon.float().square().mean().backward()
        assert calls == {"forward": forwards, "backward": blocks}, (remat, calls)
    with torch.no_grad():  # no graph: nothing is checkpointed or recomputed
        calls.update(forward=0, backward=0)
        enable_gradient_checkpointing(model)(x)
        assert calls == {"forward": blocks, "backward": 0}


# -- dropout ------------------------------------------------------------------
def test_dropout_off_when_deterministic_matches_no_dropout_and_jax(micro):
    port, params, batch = micro
    cfg = get_config(VARIANT, **{**MICRO, "dropout": 0.1})
    drop = TransVAE(cfg, device="cpu")
    drop.load_state_dict(port.state_dict())
    x = torch.from_numpy(batch).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = drop(x)
        for a, b in zip(got, port(x)):
            assert torch.equal(a, b)
    jm = JaxTransVAE(jax_get_config(VARIANT, **{**MICRO, "dropout": 0.1}))
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, sample=False,
                                        deterministic=True))(params, batch)
    for r, g in zip(ref, got):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("module", ["attention", "conv_ffn"])
def test_dropout_on_drops_about_p_and_rescales(module):
    p = 0.25
    torch.manual_seed(0)
    if module == "attention":
        m = AttentionRoPE(32, 16, impl="auto_train", dropout=p)
    else:
        m = ConvFFN(32, dropout=p)
    for t in m.parameters():
        torch.nn.init.normal_(t, std=0.2)
    x = torch.randn(4, 32, 16, 16)
    with torch.no_grad():
        det = m(x)
        assert torch.equal(det, m(x, deterministic=True))
        out = m(x, deterministic=False)
    kept = out != 0
    frac = 1.0 - kept.float().mean().item()
    assert abs(frac - p) < 0.02, frac
    torch.testing.assert_close(out[kept], det[kept] / (1 - p), rtol=1e-6, atol=1e-6)


def test_training_step_never_enables_dropout(micro):
    port, _, batch = micro
    drop = TransVAE(get_config(VARIANT, **{**MICRO, "dropout": 0.5}), device="cpu")
    drop.load_state_dict(port.state_dict())
    weights = LossWeights(**WEIGHTS)
    gen = torch.Generator().manual_seed(0)
    got, m_drop = compute_grads(drop, torch.from_numpy(batch), weights, generator=gen)
    gen = torch.Generator().manual_seed(0)
    ref, m_ref = compute_grads(port, torch.from_numpy(batch), weights, generator=gen)
    assert float(m_drop["total"]) == float(m_ref["total"])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
