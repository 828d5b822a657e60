"""The model's GroupNorm -> SiLU sites (``ops.norms.group_norm_silu``) and
the gate that sends them to the fused kernels
(``ops/hopper/fused_norm.py::group_norm_silu_supported``).

The gate (device, dtype, grad) is walked over every ``VARIANTS`` entry at
256/512/1024px on the meta device (shapes only, no memory); each site's map
is then made channels_last, as the card's convolutions leave it, and the
kernels must take it (``_layout_error``) and refuse its NCHW-contiguous
twin, which on the card raises rather than falling back. On the CPU the
gate refuses, so the model's output is bit-equal with the switch
(``ops.norms.FUSE_NORM_SILU``) on and off, and the sites' counts agree with
``chip_smoke.py``'s launch table (``norm_sites``). The converted JAX
weights reach the sites unchanged, and the function the card runs there
matches the JAX function (``pallas_call`` in interpret mode) with the JAX
tree's own scale and bias (1e-5 abs + 1e-4 rel in fp32).
"""

import collections
import functools
import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepl_project_tpu.ops.pallas.fused_norm as jfnorm
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import VARIANTS, get_config
from deepl_project_tpu_torch.models import TransVAE, init_weights
from deepl_project_tpu_torch.ops import norms
from deepl_project_tpu_torch.ops.blocks import ResBlock
from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
from deepl_project_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

MICRO = dict(depths=(1, 1, 1, 1, 1), base_dims=(16, 16, 32, 64, 64), latent_dim=4,
             head_dim=16)
GATE = fnorm.group_norm_silu_supported  # the fixture below puts a spy in its place


@pytest.fixture
def sites(monkeypatch):
    """Every call of the gate: (x, params)."""
    calls = []

    def spy(x, *params):
        calls.append((x, params))
        return GATE(x, *params)

    monkeypatch.setattr(fnorm, "group_norm_silu_supported", spy)
    return calls


def _site_modules(model):
    """The weights of the GroupNorms that feed a SiLU: both of every
    ResBlock's and the decoder's norm_out (not the latent GroupNorm)."""
    out = [n.weight for m in model.modules() if isinstance(m, ResBlock)
           for n in (m.norm1, m.norm2)]
    return {id(w) for w in out + [model.decoder.norm_out.weight]}


def _counts(calls):
    return collections.Counter((x.shape[2] * x.shape[3], x.shape[1]) for x, _ in calls)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gate_accepts_exactly_the_sites_of_every_variant(sites, variant):
    cfg = get_config(variant, attention_impl="xla", dtype="bfloat16", norm_latents=True)
    with torch.device("meta"):
        model = TransVAE(cfg)
    for res in (256, 512, 1024):
        sites.clear()
        with torch.no_grad():
            model(torch.empty(1, 3, res, res, device="meta", dtype=torch.bfloat16))
        assert {id(p[0]) for _, p in sites} == _site_modules(model)
        assert _counts(sites) == chip_smoke.norm_sites(model, res)
        for x, params in sites:
            groups = norms.gn_groups(x.shape[1])
            cl = torch.empty(x.shape, device="meta", dtype=torch.bfloat16,
                             memory_format=torch.channels_last)
            assert x.shape[1] in (128, 192, 256, 320, 384) and groups == 32
            assert fnorm._layout_error(cl, groups) is None
            assert "strides" in fnorm._layout_error(cl.contiguous(), groups)
            with torch.no_grad():
                assert not GATE(cl, *params)  # not CUDA
                assert GATE(_card(), *params)
                assert not GATE(_card(torch.float32), *params)
            assert not GATE(_card(), *params)  # the params ask for grad


def _card(dtype=torch.bfloat16, grad=False):
    """What the gate reads of a CUDA map (the CPU has none)."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, requires_grad=grad)


def test_gate_refuses_grad_fp32_cpu_nchw_and_odd_widths(monkeypatch):
    x = torch.randn(2, 64, 4, 6, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.nn.Parameter(torch.ones(64))
    with torch.no_grad():
        assert GATE(_card(), w) and not GATE(x, w)  # CPU
        assert not GATE(_card(torch.float32), w)
        assert GATE(_card(grad=True), w)  # no grad mode
    assert not GATE(_card(), w)
    assert not GATE(_card(grad=True))
    assert GATE(_card(), w.detach())
    # The layouts the kernels refuse: the gate passes them to the kernels,
    # which raise.
    assert fnorm._layout_error(x, 32) is None
    assert "multiple" in fnorm._layout_error(x, 24)  # 64 % 24
    odd = torch.zeros(2, 12, 4, 4, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert "multiple" in fnorm._layout_error(odd, 4)  # 12 % 8
    assert "non-empty" in fnorm._layout_error(x[:0], 32)
    nchw = x.contiguous()
    with pytest.raises(ValueError, match=r"channels_last.*strides \(1536, 24, 6, 1\)"):
        fnorm.stats(nchw.to("meta"))
    # apply refuses partials of another row split than its own map's (here
    # a card of 132 SMs: [8, 192, 256, 256] in 40 slabs); _check stands in
    # for a CUDA map.
    monkeypatch.setattr(fnorm, "_check", lambda x, groups: 1)
    monkeypatch.setattr(fnorm, "_resident_blocks", lambda index: 4 * 132)
    m = torch.empty(8, 192, 256, 256, device="meta", dtype=torch.bfloat16,
                    memory_format=torch.channels_last)
    assert -(-256 * 256 // fnorm._rows_per_slab(m)) == 40
    ones = torch.ones(192, device="meta")
    for slabs in (39, 41):
        with pytest.raises(ValueError, match=r"\[8, 40, 2, 192\] \(stats of this map"):
            fnorm.apply(m, torch.empty(8, slabs, 2, 192, device="meta"), ones, ones, 32)


def test_model_is_bit_equal_with_the_flag_on_and_off_on_the_cpu(sites):
    cfg = get_config("tiny_f16d32", **MICRO, dtype="bfloat16", attention_impl="xla")
    model = init_weights(TransVAE(cfg, device="cpu").eval(), torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        on = model(x)
        assert _counts(sites) == chip_smoke.norm_sites(model, 32)
        assert len(sites) == 2 * 4 + 1  # one ResBlock a CNN stage, each side
        assert all(x.is_contiguous(memory_format=torch.channels_last) for x, _ in sites)
        chip_smoke.set_fused_norm(False)
        try:
            sites.clear()
            off = model(x)
            assert not sites and chip_smoke.norm_sites(model, 32) == {}
        finally:
            chip_smoke.set_fused_norm(True)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    table = chip_smoke.norm_table(model, 32, forwards=3)
    # At 32x32: the encoder's first ResBlock, the decoder's last and norm_out.
    assert table[("group_norm_stats", 32 * 32, 16)] == 3 * 5
    assert sum(table.values()) == 2 * 3 * 9


def test_weights_carried_across_reach_the_sites(monkeypatch):
    # Random norm affines in the JAX tree; the port loads it; each site's
    # weights are the tree's, and the fused function on them (what the card
    # runs at the site; its plain version here) matches the JAX function
    # with the tree's own scale and bias.
    monkeypatch.setattr(jfnorm.pl, "pallas_call",
                        functools.partial(jfnorm.pl.pallas_call, interpret=True))
    cfg = get_config("tiny_f16d32", **MICRO, dtype="float32")
    src = init_weights(TransVAE(cfg, device="cpu"), torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    for k in sd:
        if ".norm" in k:
            sd[k] = (sd[k] + 0.3 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    params = torch_state_dict_to_params(sd, jax_get_config("tiny_f16d32", **MICRO,
                                                           dtype="float32"))
    port = TransVAE(cfg, device="cpu").eval()
    load_jax_params(port, params)
    tree = jax_to_sd(params, None)
    named = [(f"{n}.{k}", getattr(m, k)) for n, m in port.named_modules()
             if isinstance(m, ResBlock) for k in ("norm1", "norm2")]
    named.append(("decoder.norm_out", port.decoder.norm_out))
    assert len(named) == 9
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    for name, norm in named:
        scale, bias = tree[f"{name}.weight"], tree[f"{name}.bias"]
        np.testing.assert_array_equal(norm.weight.detach().numpy(), scale)
        np.testing.assert_array_equal(norm.bias.detach().numpy(), bias)
        if name.endswith(("stages.0.0.norm1", "norm_out")):
            want = np.asarray(jfnorm.group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                                     jnp.asarray(bias), groups=16,
                                                     block_rows=16))
            with torch.no_grad():
                for got in (fnorm.group_norm_silu(tx, norm.weight, norm.bias,
                                                  norm.num_groups, norm.eps),
                            norms.group_norm_silu(norm, tx)):
                    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                               atol=1e-5, rtol=1e-4)
