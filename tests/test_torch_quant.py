"""The port's int8 post-training quantization against the JAX package's.

Primitives on the same numpy inputs: ``quantize_weight`` (int8 values and
scales) and ``quantize_act`` bit-equal, the int8 matmul's and convolution's
int32 accumulators bit-equal. Modules: a JAX float ResBlock / ConvFFN is
calibrated and quantized by the JAX package (``quantize_params``), the int8
tree is carried into the port's int8 module, and both run the same input
eagerly with every ``quantize_act`` call recorded: the quantized activations
at each site must agree in >= 99.9% of elements and differ by at most one
step elsewhere. Outputs, fp32: when no activation flips, within fp32
rounding (atol 2e-4 x max|ref|); each flipped element may move an output by
act_scale x max|kernel| of the layer it feeds, so the bound adds that for
every flip. Whole model (a micro TransVAE, fp32): the port's
``calibrate_amax`` within 1e-4 relative of JAX's at every site; for each
scope the port's ``quantize_model`` gives JAX's int8 tree (the JAX side is
``quantize_model``'s body: one calibration shared by the three scopes, then
``quantize_params`` and the int8 model), and it and the JAX-quantized tree
loaded into the port reconstruct within relative L2 1e-2 of the JAX int8
model, or within twice the JAX int8 model's own move under 1e-6 relative
input noise where that is larger: int8 rounding is discontinuous, and in
this random micro model with ResBlocks in scope one flipped activation
grows into thousands by the decoder (JAX alone: 2.3% / 3.1% at scopes
'resblock' / 'all' under that noise; 'ffn': 1e-2 holds).
A scan-layout JAX tree (``to_scanned_params``) loads and reproduces the
unrolled forward exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.cli import serve as jserve
from deepl_project_tpu.ops import blocks as jblocks
from deepl_project_tpu.ops import ffn as jffn
from deepl_project_tpu.ops import quant as jquant
from deepl_project_tpu.ops.stack import to_scanned_params
from deepl_project_tpu.quantize import calibrate_amax as jcalibrate_amax
from deepl_project_tpu.quantize import quantize_params
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.cli import serve
from deepl_project_tpu_torch.models import TransVAE, init_weights
from deepl_project_tpu_torch.ops import blocks, ffn, quant
from deepl_project_tpu_torch.quantize import calibrate_amax, quantize_model
from deepl_project_tpu_torch.utils.convert import (load_jax_params, load_state_dict,
                                                   params_to_torch_state_dict,
                                                   quantized_params_to_torch_state_dict)

torch.set_num_threads(2)
F32 = jnp.float32
MICRO = dict(depths=(1, 1, 1, 1, 1), base_dims=(16, 16, 32, 64, 64), latent_dim=4,
             head_dim=16, dtype="float32")


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 3, 16, 24), (48, 32), (64, 8)])
def test_quantize_weight_bit_equal_to_jax(shape):
    w = _x(shape, seed=1, scale=0.3)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    jq, js = jquant.quantize_weight(jnp.asarray(w), axis=-1)
    tq, ts = quant.quantize_weight(torch.from_numpy(w), axis=-1)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_act_bit_equal_to_jax():
    # Values on the half-step boundaries (round half to even) and past the
    # clip, besides random ones.
    s = np.float32(0.0123)
    x = np.concatenate([(np.arange(-140, 140) + 0.5).astype(np.float32) * s,
                        _x((4096,), seed=2, scale=0.8)])
    want = np.asarray(jquant.quantize_act(jnp.asarray(x), jnp.asarray(s)))
    got = quant.quantize_act(torch.from_numpy(x), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["matmul", "conv3", "conv1", "conv3_chunked"])
def test_int_accumulators_and_dequant_bit_equal_to_jax(kind, monkeypatch):
    rng = np.random.default_rng(3)
    i8 = lambda shape: rng.integers(-127, 128, shape, dtype=np.int8)  # noqa: E731
    ks = rng.random(24, dtype=np.float32) * 0.01
    a, bias = np.float32(0.02), _x((24,), seed=4)
    if kind == "matmul":
        xq, kq = i8((40, 56)), i8((56, 24))
        want = lax.dot_general(jnp.asarray(xq), jnp.asarray(kq), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
        got = quant.int_mm(torch.from_numpy(xq), torch.from_numpy(kq.T.copy()))
        x = _x((40, 56))
        deq_j = jquant.qmatmul(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(ks),
                               jnp.asarray(a), jnp.asarray(bias), out_dtype=F32)
        deq_t = quant.qmatmul(torch.from_numpy(x), torch.from_numpy(kq.T.copy()),
                              torch.from_numpy(ks), torch.tensor(a), torch.from_numpy(bias),
                              out_dtype=torch.float32)
    else:
        k = 1 if kind == "conv1" else 3
        if kind == "conv3_chunked":  # one image per chunk
            monkeypatch.setattr(quant, "_IM2COL_BYTES", 1)
        xq, kq = i8((3, 7, 9, 16)), i8((k, k, 16, 24))
        want = lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(kq), (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
        tk = torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 0, 1, 2)))
        got = quant.int_conv(torch.from_numpy(xq), tk)
        x = _x((3, 7, 9, 16))
        deq_j = jquant.qconv(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(a),
                             jnp.asarray(bias), out_dtype=F32)
        deq_t = quant.qconv(torch.from_numpy(x), tk, torch.from_numpy(ks), torch.tensor(a),
                            torch.from_numpy(bias), out_dtype=torch.float32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(deq_t.numpy(), np.asarray(deq_j))


def _record(monkeypatch, module, into):
    orig = module.quantize_act

    def rec(x, s):
        out = orig(x, s)
        into.append((np.asarray(out), float(np.asarray(s))))
        return out

    monkeypatch.setattr(module, "quantize_act", rec)


def _int8_pair(jfloat, jint8, tint8, x_nhwc, monkeypatch):
    """Calibrate and quantize the JAX float module, carry the int8 tree into
    the port's module, run both eagerly recording the quantized activations;
    returns (JAX output, port output NHWC, JAX acts, port acts, qparams)."""
    x = jnp.asarray(x_nhwc)
    params = jfloat.init(jax.random.PRNGKey(0), x)["params"]
    _, mut = jfloat.clone(calibrate=True).apply({"params": params}, x,
                                                mutable=["intermediates"])
    qparams = jax.tree_util.tree_map(
        np.asarray, quantize_params(params, mut["intermediates"], scope="all"))
    load_state_dict(tint8, quantized_params_to_torch_state_dict(qparams))
    jacts, tacts = [], []
    _record(monkeypatch, jquant, jacts)
    _record(monkeypatch, quant, tacts)
    ref = np.asarray(jint8.apply({"params": qparams}, x))
    with torch.inference_mode():
        got = tint8(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous())
    return ref, got.permute(0, 2, 3, 1).numpy(), jacts, tacts, qparams


def _check_int8(ref, got, jacts, tacts, feeds):
    """feeds[i]: max|kernel| (dequantized) of the layer site i feeds."""
    assert len(jacts) == len(tacts) == len(feeds)
    allowance = 0.0
    for (ja, js), (ta, ts), wmax in zip(jacts, tacts, feeds):
        assert ja.shape == ta.shape and js == ts
        diff = np.abs(ja.astype(np.int32) - ta.astype(np.int32))
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1, (diff.mean(), diff.max())
        allowance += int(diff.sum()) * js * wmax
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * np.abs(ref).max() + allowance)


def _wmax(node):
    return float(np.max(np.abs(node["kernel_q"].astype(np.float32)) * node["kernel_scale"]))


@pytest.mark.parametrize("cin,cout,conv_sc", [(16, 16, False), (16, 32, False), (16, 32, True)])
def test_int8_resblock_matches_jax(cin, cout, conv_sc, monkeypatch):
    x = _x((2, 8, 8, cin))
    mk = lambda **kw: jblocks.ResBlock(cin, cout, use_conv_shortcut=conv_sc,  # noqa: E731
                                       dtype=F32, **kw)
    ref, got, ja, ta, qp = _int8_pair(mk(), mk(quant="int8"),
                                      blocks.ResBlock(cin, cout, conv_sc, quant="int8"),
                                      x, monkeypatch)
    feeds = [_wmax(qp["conv1"]), _wmax(qp["conv2"])]
    if cin != cout:  # the shortcut's site comes after conv2's
        feeds.append(_wmax(qp["shortcut"]))
    _check_int8(ref, got, ja, ta, feeds)


def test_int8_conv_ffn_matches_jax(monkeypatch):
    x = _x((2, 6, 6, 16))
    ref, got, ja, ta, qp = _int8_pair(jffn.ConvFFN(16, dtype=F32),
                                      jffn.ConvFFN(16, quant="int8", dtype=F32),
                                      ffn.ConvFFN(16, quant="int8"), x, monkeypatch)
    w = lambda k: float(np.max(np.abs(qp[k + "_q"].astype(np.float32)) * qp[k + "_scale"]))  # noqa: E731,E501
    _check_int8(ref, got, ja, ta,
                [_wmax(qp["proj_in"]), w("w_head"), _wmax(qp["conv_1"]), w("w_fold")])


# -- whole model ------------------------------------------------------------
def _batches():
    rng = np.random.default_rng(7)
    return [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def micro():
    """(port float model, JAX config, JAX params, JAX amax) on the same
    weights: drawn by the port, carried to the JAX tree."""
    cfg = get_config("tiny_f16d32", **MICRO)
    port = TransVAE(cfg, device="cpu")
    init_weights(port, torch.Generator().manual_seed(0))
    jcfg = jax_get_config("tiny_f16d32", **MICRO)
    params = torch_state_dict_to_params({k: v.numpy() for k, v in port.state_dict().items()},
                                        jcfg)
    amax = jcalibrate_amax(jcfg, params, _batches())
    return port.eval(), jcfg, params, amax


def _site_name(path):
    """JAX amax path (encoder, stage2_block0, ffn) -> 'encoder.stages.2.0.ffn'."""
    out = []
    for p in path:
        if p.startswith("stage") and "_block" in p:
            out += ["stages", *p[5:].split("_block")]
        else:
            out.append(p)
    return ".".join(out)


def test_calibrate_amax_matches_jax(micro):
    port, _, _, amax = micro
    got = calibrate_amax(port, _batches())
    want = {}
    for path, v in jax.tree_util.tree_leaves_with_path(amax):
        keys = [k.key for k in path]
        want.setdefault(_site_name(keys[:-1]), {})[keys[-1]] = float(v)
    assert set(got) == set(want)
    for name, sites in want.items():
        assert set(got[name]) == set(sites), name
        for site, v in sites.items():
            np.testing.assert_allclose(float(got[name][site]), v, rtol=1e-4, err_msg=name + site)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("scope", ["all", "resblock", "ffn"])
def test_quantize_model_matches_jax(micro, scope):
    port, jcfg, params, amax = micro
    qcfg = jcfg.replace(quant="int8", quant_scope=scope)
    qparams = jax.tree_util.tree_map(np.asarray, quantize_params(params, amax, scope=scope))
    fwd = jax.jit(lambda p, x: JaxTransVAE(qcfg).apply({"params": p}, x, sample=False)[0])
    x = np.random.default_rng(8).random((2, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(fwd(qparams, x))
    # The JAX int8 model's own sensitivity: its reconstruction of x moved by
    # 1e-6 relative noise (a few fp32 ulps, the size of the two packages'
    # fp32 differences at the first site).
    noise = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    floor = _rel_l2(np.asarray(fwd(qparams, x * (1 + 1e-6 * noise))), ref)
    qport = quantize_model(port, _batches(), scope)
    assert qport.config.quant == "int8" and qport.config.quant_scope == scope
    # The transform: JAX's int8 tree, int8 kernels bit-equal (W_fold folded
    # in fp32 on both sides), scales within the calibration's 1e-4.
    want = params_to_torch_state_dict(qparams)
    got = {k: v.numpy() for k, v in qport.state_dict().items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if v.dtype == np.int8:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=0, err_msg=k)
    from_jax = TransVAE(get_config("tiny_f16d32", **MICRO, quant="int8", quant_scope=scope),
                        device="cpu").eval()
    load_jax_params(from_jax, qparams)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        for model in (qport, from_jax):
            got = model(xt)[0].permute(0, 2, 3, 1).numpy()
            assert _rel_l2(got, ref) < max(1e-2, 2 * floor), (_rel_l2(got, ref), floor)


def test_quantize_model_refuses_what_jax_refuses(micro):
    port = micro[0]
    with pytest.raises(ValueError, match="empty"):
        quantize_model(port, [], "all")
    with pytest.raises(ValueError, match="all\\|resblock\\|ffn"):
        quantize_model(port, _batches(), "attention")
    dw = TransVAE(get_config("tiny_f16d32", **MICRO, conv_ffn_type="depthwise"), device="cpu")
    with pytest.raises(ValueError, match="conv_ffn_type='full'"):
        quantize_model(dw, _batches(), "all")


def test_scan_layout_tree_loads_and_reproduces_unrolled(micro):
    port, jcfg, params, _ = micro
    scanned = jax.tree_util.tree_map(np.asarray, to_scanned_params(params, jcfg))
    assert "stage0_blocks" in scanned["encoder"]
    model = TransVAE(port.config, device="cpu").eval()
    load_jax_params(model, scanned)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(9))
    with torch.inference_mode():
        torch.testing.assert_close(model(x)[0], port(x)[0], rtol=0, atol=0)
    assert params_to_torch_state_dict(params).keys() == port.state_dict().keys()


# -- the serve CLI ------------------------------------------------------------
@pytest.mark.parametrize("quantize,mesh", [(None, 1), (None, 2), ("none", 1), ("int8", 1),
                                           ("int8", 2)])
def test_serve_resolve_quantize(quantize, mesh):
    # The JAX package's flags and explicit choices; an unset --quantize is
    # the port's own choice, the float model (int8 is slower on an H100),
    # where the JAX package's is int8 on one device.
    want = "none" if quantize is None else jserve.resolve_quantize(quantize, mesh)
    assert serve.resolve_quantize(quantize, mesh) == want
    args = serve.build_parser().parse_args([])
    jargs = jserve.build_parser().parse_args([])
    assert (args.quantize, args.quantize_scope) == (jargs.quantize, jargs.quantize_scope)


def test_serve_engine_quantizes_at_the_scope(tmp_path):
    src = TransVAE(get_config("tiny_f16d32", **MICRO), device="cpu")
    init_weights(src, torch.Generator().manual_seed(3))
    path = tmp_path / "model.pt"
    torch.save({"model_state_dict": src.state_dict(),
                "config": {"variant": "tiny_f16d32", **MICRO}}, path)
    args = serve.build_parser().parse_args(
        ["--checkpoint", str(path), "--device", "cpu", "--quantize", "int8",
         "--quantize_scope", "ffn", "--warmup_resolution", "32", "--max_batch", "2"])
    eng = serve.build_engine(args)
    cfg = eng.model.config
    assert (cfg.quant, cfg.quant_scope) == ("int8", "ffn")
    assert any(k.endswith("w_fold_q") for k in eng.model.state_dict())
    x = np.random.default_rng(5).random((2, 32, 32, 3), dtype=np.float32)
    out = eng.run("reconstruct", x, "uint8")
    assert out.shape == (2, 32, 32, 3) and out.dtype == np.uint8
