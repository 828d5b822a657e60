"""One rank's heads of the attention sublayer (tensor parallelism) on the
plain versions of the sublayer kernels, on the CPU: the local q/k/v are the
whole layer's columns of the rank's heads, and the ranks' partial products
summed, plus the bias once, are the whole sublayer's output.

fp32 at a small width (C=256, four heads of 64; m = 2 and 4): within 1e-5
of the largest value. The module's local kernel route (``local_kernel_heads``:
``local_sublayer`` or ``ln_qkv_rope`` -> the core -> the partial
projection) in bf16: within 2^-6 of the largest, the card's bar for a
kernel against its plain version (each rank rounds its partial products to
bf16 before the sum).
"""

import numpy as np
import pytest
import torch

from deepl_project_tpu_torch.ops import attention as attn_mod
from deepl_project_tpu_torch.ops.attention import AttentionRoPE
from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab

torch.set_num_threads(2)
C, HD = 256, 64


def _inputs(b, h, w, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    x = t(b, h * w, C).to(dtype)
    ln = tuple((t(C, scale=0.1, shift=1.0), t(C, scale=0.1)) for _ in range(3))
    ws = [t(C, C, scale=2 / C ** 0.5) for _ in range(4)]
    return x, ln, ws, t(C, scale=0.1)


def _close(got, want, rel):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()), err


@pytest.mark.parametrize("m", [2, 4])
def test_local_heads_sum_to_the_whole_sublayer(m):
    h = w = 8
    x, ln, (wq, wk, wv, wp), bp = _inputs(2, h, w)
    width = C // m
    whole_qkv = fab.qkv_rope_reference(x, ln, wq, wk, wv, h, w)
    total = 0
    for r in range(m):
        cols = slice(r * width, (r + 1) * width)
        local = [t[cols] for t in (wq, wk, wv)]
        for got, want in zip(fab.qkv_rope_reference(x, ln, *local, h, w), whole_qkv):
            assert got.shape == (2, h * w, width)
            _close(got, want[..., cols], 1e-5)
        part = fab.local_sublayer_reference(x, ln, *local, wp[:, cols], h, w)
        torch.testing.assert_close(part, fab.local_sublayer(x, ln, *local, wp[:, cols], h, w),
                                   atol=0, rtol=0)
        total = total + part
    _close(total + bp, fab.sublayer_reference(x, ln, wq, wk, wv, wp, bp, h, w), 1e-5)


@pytest.mark.parametrize("m", [2, 4])
def test_pack_qkv_permutes_within_local_heads(m):
    _, ln, (wq, wk, wv, _), _ = _inputs(1, 4, 4, seed=1)
    width = C // m
    whole, gb = fab.pack_qkv(ln, wq, wk, wv, HD)
    pad = fab.padded_width(width)
    assert pad == (128 if width == 64 else width)
    for r in range(m):
        cols = slice(r * width, (r + 1) * width)
        packed, gbl = fab.pack_qkv(ln, wq[cols], wk[cols], wv[cols], HD)
        assert packed.shape == (3 * pad, C)
        torch.testing.assert_close(gbl, gb, atol=0, rtol=0)  # LN affines stay whole
        for branch in range(3):
            mine = packed[branch * pad:branch * pad + width]
            theirs = whole[branch * C + r * width:branch * C + (r + 1) * width]
            torch.testing.assert_close(mine, theirs, atol=0, rtol=0)
            assert not packed[branch * pad + width:(branch + 1) * pad].any()
        # q's rows: each local head's even entries, then its odd ones.
        perm = torch.from_numpy(fab.head_perm(width // HD, HD))
        torch.testing.assert_close(packed[:width], wq[cols][perm].to(torch.bfloat16),
                                   atol=0, rtol=0)


def _shards(full, m):
    shards = []
    for r in range(m):
        s = AttentionRoPE(C, HD, impl="auto")
        s.load_state_dict(full.state_dict())
        rows = slice(r * C // m, (r + 1) * C // m)
        with torch.no_grad():
            for lin in (s.to_q, s.to_k, s.to_v):
                lin.weight = torch.nn.Parameter(lin.weight[rows].clone())
            s.proj.weight = torch.nn.Parameter(s.proj.weight[:, rows].clone())
        shards.append(s)
    return shards


@pytest.mark.parametrize("side,dtype,route", [(16, torch.bfloat16, "local_sublayer"),
                                              (8, torch.float32, "local_ln_qkv_rope")])
def test_module_local_kernel_route_sums_to_the_whole(side, dtype, route):
    # bf16 at N=256 passes the sublayer gate at W = 128 (the whole local
    # sublayer); fp32 is refused by it, so the method takes ln_qkv_rope ->
    # the core -> the partial projection (both plain on the CPU).
    torch.manual_seed(0)
    full = AttentionRoPE(C, HD, impl="auto")
    with torch.no_grad():
        full.proj.bias.normal_()
    x = torch.randn(2, C, side, side).to(dtype)
    xf = x.permute(0, 2, 3, 1).reshape(2, side * side, C)
    attn_mod.reset_route_counts()
    with torch.no_grad():
        got = sum(s.local_kernel_heads(xf, side, side) for s in _shards(full, 2))
        got = got + full.proj.bias.to(dtype)
        assert attn_mod.route_counts() == {route: 2}
        full.impl = "xla"
        want = full(x).permute(0, 2, 3, 1).reshape(2, side * side, C)
    _close(got, want, 2 ** -6 if dtype == torch.bfloat16 else 1e-5)
