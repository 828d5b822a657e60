"""The port's attention-sublayer functions against the JAX package's.

Rows 1-2 of the TPU kernel table (deepl_project_tpu/ops/pallas/
fused_attention_block.py): the plain PyTorch versions that the port's CPU
wrappers run are held against the JAX plain references (``_reference``,
``qkv_rope_reference``) and against the Pallas kernels in interpret mode, on
the same numpy inputs. The CUDA kernels themselves run only on a card
(tests/test_torch_cuda_kernels.py; ``python3 chip_smoke.py`` runs them at
full size).

Tolerances: fp32 end to end, 2e-4 abs/rel (different summation orders,
fp32 exp); bf16, 2**-6 * max|ref| (two bf16 rounding steps at the largest
magnitude: both packages round at the same places, but an fp32 sum in a
different order can land on the other side of a bf16 rounding boundary).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deepl_project_tpu.ops.pallas import fused_attention_block as jfab
from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
from deepl_project_tpu_torch.ops.rope import rope2d_tables

torch.set_num_threads(2)
ATOL = RTOL = 2e-4


def _inputs(c, hd, h=16, w=16, b=2, seed=0, wscale=None):
    """Seeded numpy inputs: x [B,N,C]; LN affines; JAX-layout [in, out]
    weights (the port takes their transposes, nn.Linear layout)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    n = h * w
    wscale = wscale or 1.0 / np.sqrt(c)
    x = rng.standard_normal((b, n, c)).astype(f)
    ln = tuple((1 + 0.1 * rng.standard_normal(c).astype(f),
                0.1 * rng.standard_normal(c).astype(f)) for _ in range(3))
    wq, wk, wv, wp = (wscale * rng.standard_normal((c, c)).astype(f) for _ in range(4))
    bp = 0.1 * rng.standard_normal(c).astype(f)
    return x, ln, (wq, wk, wv, wp), bp


def _torch_args(x, ln, ws, dtype=torch.float32):
    tx = torch.from_numpy(x).to(dtype)
    tln = tuple((torch.from_numpy(g), torch.from_numpy(b)) for g, b in ln)
    tw = tuple(torch.from_numpy(np.ascontiguousarray(w.T)) for w in ws)
    return tx, tln, tw


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("pairing", ["reference", "standard"])
def test_ln_qkv_rope_plain_matches_jax_and_pallas(pairing):
    # 4 heads of 32: per-head permutation and RoPE halves across heads.
    c, hd, h, w = 128, 32, 16, 16
    x, ln, (wq, wk, wv, _), _ = _inputs(c, hd, h, w)
    jargs = (jnp.asarray(x), tuple((jnp.asarray(g), jnp.asarray(b)) for g, b in ln),
             jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv), h, w)
    ref = jfab.qkv_rope_reference(*jargs, pairing=pairing, head_dim=hd)
    pallas = jfab.fused_qkv_rope(*jargs, pairing=pairing, head_dim=hd, interpret=True)
    tx, tln, (twq, twk, twv, _) = _torch_args(x, ln, (wq, wk, wv, wq))
    got = fab.ln_qkv_rope(tx, tln, twq, twk, twv, h, w, pairing, hd)  # CPU: plain
    for g, r, p in zip(got, ref, pallas):
        _close(g, r)
        _close(g, p)


@pytest.mark.parametrize("pairing,hd", [("reference", 32), ("standard", 16), ("reference", 64)])
def test_sublayer_plain_matches_jax_and_pallas(pairing, hd):
    # head_dim 64 is the card kernels' own head width (2 heads at C = 128).
    c, h, w = 128, 16, 16
    x, ln, ws, bp = _inputs(c, hd, h, w, seed=1)
    jln = tuple((jnp.asarray(g), jnp.asarray(b)) for g, b in ln)
    jws = tuple(jnp.asarray(t) for t in ws)
    ref = jfab._reference(jnp.asarray(x), jln, *jws, jnp.asarray(bp), h, w,
                          pairing, hd, hd ** -0.5, True)
    pallas = jfab.fused_attention_sublayer(jnp.asarray(x), jln, *jws, jnp.asarray(bp),
                                           h, w, pairing=pairing, head_dim=hd,
                                           interpret=True)
    tx, tln, tws = _torch_args(x, ln, ws)
    got = fab.fused_attention_sublayer(tx, tln, *tws, torch.from_numpy(bp), h, w,
                                       pairing, hd)
    _close(got, ref)
    _close(got, pallas)


def test_kernel_split_equals_sublayer():
    # The card runs the sublayer as ln_qkv_rope -> attention_core ->
    # proj_bias_gemm on PERMUTED q/k; the composition of their plain versions
    # must equal the port of _reference (natural layout).
    c, hd, h, w = 128, 32, 8, 16
    x, ln, ws, bp = _inputs(c, hd, h, w, seed=2, wscale=2.0 / np.sqrt(128))
    tx, tln, (twq, twk, twv, twp) = _torch_args(x, ln, ws)
    tbp = torch.from_numpy(bp)
    q, k, v = fab.ln_qkv_rope(tx, tln, twq, twk, twv, h, w, head_dim=hd)
    o = fab.attention_core(q, k, v, hd ** -0.5, head_dim=hd)
    got = fab.proj_bias_gemm(o, twp, tbp)
    want = fab.sublayer_reference(tx, tln, twq, twk, twv, twp, tbp, h, w, head_dim=hd)
    _close(got, want)


@pytest.mark.parametrize("c,h,w", [(128, 16, 16), (256, 8, 8)])
def test_bf16_plain_matches_jax_reference(c, h, w):
    # The kernels' working precision and head width (hd=64): both packages
    # round x-hat, each branch input and each projection to bf16.
    hd = 64
    x, ln, ws, bp = _inputs(c, hd, h, w, seed=3, wscale=2.0 / np.sqrt(c))
    jx = jnp.asarray(x, jnp.bfloat16)
    jln = tuple((jnp.asarray(g), jnp.asarray(b)) for g, b in ln)
    jws = tuple(jnp.asarray(t) for t in ws)
    tx, tln, tws = _torch_args(x, ln, ws, torch.bfloat16)  # same rounding as jx
    ref_q = jfab.qkv_rope_reference(jx, jln, *jws[:3], h, w, head_dim=hd)
    got_q = fab.qkv_rope_reference(tx, tln, *tws[:3], h, w, head_dim=hd)
    for g, r in zip(got_q, ref_q):
        r = np.asarray(r.astype(jnp.float32))
        _close(g.float(), r, atol=2 ** -6 * np.abs(r).max(), rtol=0)
    ref = np.asarray(jfab._reference(jx, jln, *jws, jnp.asarray(bp), h, w, "reference",
                                     hd, hd ** -0.5, True).astype(jnp.float32))
    got = fab.sublayer_reference(tx, tln, *tws, torch.from_numpy(bp), h, w)
    assert got.dtype == torch.bfloat16
    _close(got.float(), ref, atol=2 ** -6 * np.abs(ref).max(), rtol=0)


def test_rope_tables_match_jax():
    from deepl_project_tpu.ops.rope import _rope2d_tables_np

    for pairing in ("reference", "standard"):
        got = rope2d_tables(64, 8, 16, pairing)
        ca, sa, cb, sb = _rope2d_tables_np(64, 8, 16)
        want = (ca, sa, ca, sa) if pairing == "standard" else (ca, sa, cb, sb)
        for g, wnt in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (128, 32)
            np.testing.assert_array_equal(g.numpy(), wnt)


def test_head_perm_matches_jax():
    np.testing.assert_array_equal(fab.head_perm(3, 16), jfab._head_perm(3, 16))


def test_kernel_limits():
    bf = torch.bfloat16
    assert fab.kernel_supported(4096, 384, 64, bf)
    assert fab.sublayer_supported(1024, 768, 64, bf)
    assert fab.sublayer_supported(256, 1536, 64, bf)
    assert not fab.sublayer_supported(4096, 384, 64, bf)  # N > 1024: qkv kernel only
    assert not fab.kernel_supported(1024, 768, 32, bf)  # head_dim 64 only
    assert not fab.kernel_supported(1024, 320, 64, bf)  # C % 128
    assert not fab.kernel_supported(1000, 768, 64, bf)  # N % 64
    assert not fab.kernel_supported(1024, 768, 64, torch.float32)


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    # A tensor that is not on the CPU must reach a kernel or raise; the
    # plain versions are for CPU tensors only (meta stands in for a card).
    x = torch.empty(2, 256, 128, dtype=torch.bfloat16, device="meta")
    w = torch.empty(128, 128, device="meta")
    ln = tuple((torch.empty(128, device="meta"),) * 2 for _ in range(3))
    with pytest.raises(ValueError):
        fab.ln_qkv_rope(x, ln, w, w, w, 16, 16)
    with pytest.raises(ValueError):
        fab.attention_core(x, x, x, 0.125)
    with pytest.raises(ValueError):
        fab.proj_bias_gemm(x.float(), w, w[0])
    with pytest.raises(ValueError):
        fab.fused_attention_sublayer(x, ln, w, w, w, w, w[0], 16, 16)
    assert fab.launch_counts() == {}


@pytest.mark.parametrize("kind", ["ln_qkv_rope", "sublayer"])
def test_kernel_functions_backward_is_the_plain_vjp(monkeypatch, kind):
    # The autograd Functions around the forward-only kernels, driven on the
    # CPU with the plain forward in place of the ln_qkv_rope launch (the
    # sublayer's attention_core and proj_bias_gemm take their plain versions
    # for CPU tensors): gradients of x, the LN affines and every weight equal
    # autograd through the plain composition (fp32, 1e-5 x max|grad|).
    c, hd, h, w = 128, 32, 8, 8
    x, ln, ws, bp = _inputs(c, hd, h, w, seed=4, wscale=2.0 / np.sqrt(c))
    tx, tln, tws = _torch_args(x, ln, ws)
    tbp = torch.from_numpy(bp)
    leaves = [tx, *[t for pair in tln for t in pair], *tws, tbp]
    if kind == "ln_qkv_rope":
        leaves = leaves[:-2]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    lx, lln, lw = leaves[0], tuple(zip(leaves[1:7:2], leaves[2:7:2])), leaves[7:]
    meta = (h, w, "reference", hd, True)

    def plain_launch(xf, wpack, gb, *m):
        return torch.cat(fab.qkv_rope_reference(xf, tuple((g.detach(), b.detach()) for g, b in lln),
                                                *(t.detach() for t in lw[:3]), *m), dim=-1)

    monkeypatch.setattr(fab, "_ln_qkv_rope_kernel", plain_launch)
    packed = fab.pack_qkv(lln, *lw[:3], hd)
    flat = [t for pair in lln for t in pair]
    if kind == "ln_qkv_rope":
        out = fab._LnQkvRope.apply(lx, *flat, *lw, packed, meta)
        ref = torch.cat(fab.qkv_rope_reference(lx, lln, *lw, *meta), dim=-1)
    else:
        # The projection's operands as the forward takes them, here in the
        # run's fp32 (pack_proj casts to the kernels' bf16).
        packed = packed + tuple(t.detach() for t in lw[3:])
        out = fab._Sublayer.apply(lx, *flat, *lw, packed, meta)
        ref = fab.sublayer_reference(lx, lln, *lw, *meta)
    ct = torch.from_numpy(np.random.default_rng(5).standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, ct)
    want = torch.autograd.grad(ref, leaves, ct)
    _close(out.detach(), ref.detach())
    for g, r in zip(got, want):
        assert g is not None
        _close(g, r, atol=1e-5 * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("updated", ["weight", "bias"])
def test_attention_caches_projection_operands(updated):
    # The sublayer kernels take the projection as a bf16 weight and an fp32
    # bias. AttentionRoPE casts them once, keeps them beside pack_qkv's
    # operands, and casts again only when a parameter changes in place.
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE

    torch.manual_seed(0)
    m = AttentionRoPE(128, head_dim=64)
    with torch.no_grad():
        m.proj.bias.normal_()
    wpk, bpk = m._packed_proj()
    assert wpk.dtype == torch.bfloat16 and bpk.dtype == torch.float32
    torch.testing.assert_close(wpk, m.proj.weight.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(bpk, m.proj.bias.float(), atol=0, rtol=0)
    again = m._packed_proj()
    assert again[0] is wpk and again[1] is bpk  # cached, not cast again
    with torch.no_grad():
        getattr(m.proj, updated).add_(1.0)
    wpk2, bpk2 = m._packed_proj()
    assert wpk2 is not wpk
    torch.testing.assert_close(wpk2, m.proj.weight.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(bpk2, m.proj.bias.float(), atol=0, rtol=0)
    # The qkv operands keep their own key: a projection update leaves them.
    qkv = m._packed_qkv()
    with torch.no_grad():
        m.proj.weight.mul_(2.0)
    assert m._packed_qkv() is qkv


def test_sublayer_takes_the_cached_projection_operands():
    # proj_bias_gemm given the cast-once operands (pack_proj) computes what
    # it computes from the fp32 parameters, bit for bit, and the sublayer
    # with packed_proj equals the sublayer without it.
    c, hd, h, w = 128, 64, 8, 8
    x, ln, ws, bp = _inputs(c, hd, h, w, seed=6, wscale=2.0 / np.sqrt(c))
    tx, tln, tws = _torch_args(x, ln, ws, torch.bfloat16)
    tbp = torch.from_numpy(bp)
    o = tx  # any bf16 [B, N, C] activations
    wpk, bpk = fab.pack_proj(tws[3], tbp)
    got = fab.proj_bias_gemm(o, wpk, bpk)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, fab.proj_bias_gemm(o, tws[3], tbp), atol=0, rtol=0)
    args = (tx, tln, *tws, tbp, h, w, "reference", hd)
    torch.testing.assert_close(
        fab.fused_attention_sublayer(*args, packed_proj=(wpk, bpk)),
        fab.fused_attention_sublayer(*args), atol=0, rtol=0)
