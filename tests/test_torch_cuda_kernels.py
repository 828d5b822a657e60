"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: 2**-6 x max|plain| (two bf16 rounding steps at the largest
magnitude); shapes are small, chip_smoke.py covers the main path's.
"""

import pytest
import torch

from deepl_project_tpu_torch import create_transvae
from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
from deepl_project_tpu_torch.ops.hopper import small_attention as sma

pytestmark = pytest.mark.gpu
TOL = 2 ** -6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * want.float().abs().max().item(), err


def _sublayer_args(gen, b, n, c, h, w):
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(b, n, c).to(torch.bfloat16)
    ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
    ws = [randn(c, c, scale=2 / c ** 0.5) for _ in range(4)]
    return x, ln, ws, randn(c, scale=0.1)


@pytest.mark.parametrize("n,c,h,w,pairing", [(1024, 128, 32, 32, "reference"),
                                             (256, 384, 16, 16, "standard"),
                                             (192, 256, 12, 16, "reference")])
def test_sublayer_kernels_match_plain(gen, n, c, h, w, pairing):
    x, ln, (wq, wk, wv, wp), bp = _sublayer_args(gen, 2, n, c, h, w)
    fab.reset_launch_counts()
    got = fab.fused_attention_sublayer(x, ln, wq, wk, wv, wp, bp, h, w, pairing)
    assert fab.launch_counts() == {"ln_qkv_rope": 1, "attention_core": 1,
                                   "proj_bias_gemm": 1}
    _close(got, fab.sublayer_reference(x, ln, wq, wk, wv, wp, bp, h, w, pairing))


def test_ln_qkv_rope_long_axis_matches_plain(gen):
    # The stage-2 route: N > 1024, q/k permuted with RoPE, v plain.
    x, ln, (wq, wk, wv, _), _ = _sublayer_args(gen, 1, 4096, 384, 64, 64)
    got = fab.ln_qkv_rope(x, ln, wq, wk, wv, 64, 64)
    for g, r in zip(got, fab.qkv_rope_reference(x, ln, wq, wk, wv, 64, 64)):
        _close(g, r)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x, ln, (wq, wk, wv, wp), bp = _sublayer_args(gen, 1, 256, 128, 16, 16)
    with pytest.raises(ValueError):
        fab.ln_qkv_rope(x.float(), ln, wq, wk, wv, 16, 16)  # fp32
    with pytest.raises(ValueError):
        fab.attention_core(x[:, :100], x[:, :100], x[:, :100], 0.125)  # N % 64
    with pytest.raises(ValueError):
        fab.fused_attention_sublayer(x, ln, wq, wk, wv, wp, bp, 16, 16, head_dim=32)


def test_model_kernel_path_matches_plain_path(gen):
    # A micro bf16 model whose transformer stages take the kernel routes
    # (head_dim 64, 128-wide). The kernel path and the plain bf16 path round
    # at different places, and random weights carry each difference through
    # the decoder, so both are held to the same weights computed in fp32
    # (TF32 off): the kernel path must be about as close to it as the plain
    # path (mean error within 1.5x, max within 2x, as in chip_smoke.py).
    kw = dict(depths=(1, 1, 1, 1, 1), base_dims=(32, 32, 128, 128, 128),
              latent_dim=4, head_dim=64)
    model = create_transvae("tiny_f16d32", device="cuda", seed=0, **kw)
    exact = create_transvae("tiny_f16d32", device="cuda", seed=None,
                            dtype="float32", **kw)
    exact.load_state_dict(model.state_dict())
    x = torch.rand(2, 3, 128, 128, generator=gen, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        with torch.inference_mode():
            fab.reset_launch_counts()
            kern = torch.sigmoid(model(x)[0].float())
            # Stages 2-3 (N=1024, 256) take the whole sublayer, enc + dec;
            # stage 4 (N=64) ln_qkv_rope and the plain core, as the JAX
            # package's route (its sublayer kernel wants N % 256 == 0).
            assert fab.launch_counts() == {"ln_qkv_rope": 6, "attention_core": 4,
                                           "proj_bias_gemm": 4}
            for m in model.modules():
                if hasattr(m, "impl"):
                    m.impl = "xla"
            plain = torch.sigmoid(model(x)[0].float())
            torch.backends.cudnn.allow_tf32 = False
            ref = torch.sigmoid(exact(x)[0])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ek, ep = (kern - ref).abs(), (plain - ref).abs()
    assert ek.mean().item() <= 1.5 * ep.mean().item(), (ek.mean(), ep.mean())
    assert ek.max().item() <= 2.0 * ep.max().item(), (ek.max(), ep.max())


@pytest.mark.parametrize("kind", ["sublayer", "ln_qkv_rope"])
def test_kernel_path_gradients_match_plain(gen, kind):
    # Training through the kernel path: the gradients reach x, the three LN
    # affines and every weight, and equal the plain path's (the backward is
    # the plain version's VJP at the same inputs and cotangent).
    b, n, c, h, w = 2, 256, 384, 16, 16
    x, ln, (wq, wk, wv, wp), bp = _sublayer_args(gen, b, n, c, h, w)
    leaves = [x, *[t for pair in ln for t in pair], wq, wk, wv, wp, bp]
    for t in leaves:
        t.requires_grad_(True)
    ct = torch.randn(b, n, 3 * c if kind == "ln_qkv_rope" else c, generator=gen,
                     device="cuda")

    def run(fn):
        out = fn(x, ln, wq, wk, wv, wp, bp, h, w)
        out = torch.cat(out, dim=-1) if kind == "ln_qkv_rope" else out
        grads = torch.autograd.grad((out.float() * ct).sum(), leaves, allow_unused=True)
        return out, grads

    if kind == "ln_qkv_rope":
        kern = lambda x, ln, wq, wk, wv, wp, bp, h, w: fab.ln_qkv_rope(x, ln, wq, wk, wv, h, w)  # noqa: E731
        plain = lambda x, ln, wq, wk, wv, wp, bp, h, w: fab.qkv_rope_reference(x, ln, wq, wk, wv, h, w)  # noqa: E731
        leaves = leaves[:-2]
    else:
        kern, plain = fab.fused_attention_sublayer, fab.sublayer_reference
    fab.reset_launch_counts()
    out_k, g_k = run(kern)
    assert fab.launch_counts()["ln_qkv_rope"] == 1
    out_p, g_p = run(plain)
    _close(out_k, out_p)
    for gk, gp in zip(g_k, g_p):
        assert gk is not None and bool(torch.isfinite(gk).all())
        _close(gk, gp)


def _flash_inputs(gen, b, n, h, packed):
    c = h * 64
    if packed:
        qkv = (2 * torch.randn(b, n, 3 * c, generator=gen, device="cuda")).to(torch.bfloat16)
        q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, 64) for i in range(3))
    else:
        q, k, v = ((2 * torch.randn(b, n, h, 64, generator=gen, device="cuda")).to(torch.bfloat16)
                   for _ in range(3))
    do = torch.randn(b, n, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, do


@pytest.mark.parametrize("b,n,h,packed", [(2, 256, 2, False), (1, 1024, 3, True),
                                          (2, 4096, 6, False), (1, 320, 2, False),
                                          (2, 192, 3, True), (1, 1088, 2, True),
                                          (1, 65536, 1, False)])
def test_flash_kernels_match_plain(gen, b, n, h, packed):
    # Forward (o, lse) and the backward (dq, dk, dv) against the plain
    # versions on the same inputs; ``packed`` feeds q/k/v as column slices of
    # one [B, N, 3C] buffer. The forward's CTA shape depends on N (64 queries
    # up to 1024, 192 above): N = 320, 192 and 1088 end on a 64-key half tile
    # of the 128-key tiles of both directions and on a partial query tile of
    # the forward, one case for each shape; N = 65536 is the 1024px stage-2
    # loop length.
    q, k, v, do = _flash_inputs(gen, b, n, h, packed)
    fla.reset_launch_counts()
    o, lse = fla.flash_forward(q, k, v, 0.125)
    o_ref, lse_ref = fla.flash_forward_reference(q, k, v, 0.125)
    _close(o, o_ref)
    _close(lse, lse_ref)
    grads = fla.flash_backward(q, k, v, o, lse, do, 0.125)
    for g, r in zip(grads, fla.flash_backward_reference(q, k, v, o, lse, do, 0.125)):
        _close(g, r)
    assert fla.launch_counts() == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("b,n,h,packed", [(2, 1024, 3, True), (1, 320, 2, False)])
def test_flash_backward_repeat_runs(gen, b, n, h, packed, deterministic):
    # By default dq's fp32 partial sums reach L2 in a run-dependent order:
    # two runs on the same inputs may differ, by no more than the kernel
    # tolerance; dk and dv are summed in registers and are bit-equal. Under
    # torch.use_deterministic_algorithms(True) the deterministic launcher
    # runs and all three are bit-equal, dq within tolerance of the plain one.
    q, k, v, do = _flash_inputs(gen, b, n, h, packed)
    o, lse = fla.flash_forward(q, k, v, 0.125)
    was = torch.are_deterministic_algorithms_enabled()
    fla.reset_launch_counts()
    try:
        torch.use_deterministic_algorithms(deterministic)
        first, second = [fla.flash_backward(q, k, v, o, lse, do, 0.125) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(was)
    name = "flash_attention_bwd_det" if deterministic else "flash_attention_bwd"
    assert fla.launch_counts() == {name: 2}
    if deterministic:
        assert torch.equal(first[0], second[0])
        _close(first[0], fla.flash_backward_reference(q, k, v, o, lse, do, 0.125)[0])
    else:
        _close(first[0], second[0])
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.parametrize("b,n,h", [(2, 64, 2), (2, 256, 4), (1, 320, 2), (2, 1024, 12)])
def test_attention_core_kernel_matches_plain(gen, b, n, h):
    # The sublayer's core alone on q/k/v column slices of one [B, N, 3C]
    # buffer, as ln_qkv_rope leaves them: one key tile (N = 64, half zero
    # fill of a 128-key tile), N = 320 (a half last key tile and a partial
    # 128-query tile), the stage-3 length. The kernel rounds the
    # unnormalised weights, the plain version the normalised ones (a known
    # port deviation): within the kernel tolerance of each other.
    c = h * 64
    qkv = (1.5 * torch.randn(b, n, 3 * c, generator=gen, device="cuda")).to(torch.bfloat16)
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    fab.reset_launch_counts()
    got = fab.attention_core(q, k, v, 0.125)
    assert fab.launch_counts() == {"attention_core": 1}
    _close(got, fab.attention_core_reference(q, k, v, 0.125))


def test_flash_attention_autograd(gen):
    q, k, v = (torch.randn(2, 512, 2, 64, generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    do = torch.randn(2, 512, 2, 64, generator=gen, device="cuda").to(torch.bfloat16)
    fla.reset_launch_counts()
    out = fla.flash_attention(q, k, v, 0.125)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert fla.launch_counts() == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    o, lse = fla.flash_forward_reference(q.detach(), k.detach(), v.detach(), 0.125)
    _close(out, o)
    want = fla.flash_backward_reference(q.detach(), k.detach(), v.detach(), o, lse, do, 0.125)
    for g, r in zip(got, want):
        _close(g, r)
    with pytest.raises(ValueError):
        fla.flash_forward(q[:, :100].detach(), k[:, :100].detach(), v[:, :100].detach(), 0.125)


@pytest.mark.parametrize("b,n,c", [(1, 64, 128), (3, 128, 128), (3, 100, 1536),
                                   (2, 1024, 768)])
def test_proj_bias_gemm_kernel_edges(gen, b, n, c):
    # The projection alone: one partial 256-row tile (M=64), C=128 (one
    # 128-column tile), M=300 at C=1536 (rows past M zero-filled on load and
    # not stored), and a stage-3 shape; bf16 weight and fp32 bias as the
    # sublayer hands them (pack_proj).
    o = torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
    wp = torch.randn(c, c, generator=gen, device="cuda") * 2 / c ** 0.5
    bp = torch.randn(c, generator=gen, device="cuda") * 0.1
    wpk, bpk = fab.pack_proj(wp, bp)
    fab.reset_launch_counts()
    got = fab.proj_bias_gemm(o, wpk, bpk)
    assert fab.launch_counts() == {"proj_bias_gemm": 1}
    assert got.shape == o.shape and got.dtype == torch.bfloat16
    _close(got, fab.proj_bias_reference(o, wp, bp))


@pytest.mark.parametrize("b,n,h,packed", [(2, 1024, 3, True), (1, 256, 2, False),
                                          (2, 960, 1, False), (1, 64, 2, False),
                                          (2, 960, 3, True), (2, 1024, 24, True)])
def test_small_attention_kernel_matches_plain(gen, b, n, h, packed):
    # The whole-head kernel (normalised weights rounded to bf16) against its
    # plain version: N=64 (one key tile), N=960 with two images (the
    # per-image tensor-map bound), packed column slices of one [B, N, 3C]
    # buffer (a row stride per tensor), the 512px stage-4 heads.
    c = h * 64
    if packed:
        qkv = (1.5 * torch.randn(b, n, 3 * c, generator=gen, device="cuda")).to(torch.bfloat16)
        q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, 64) for i in range(3))
    else:
        q, k, v = ((1.5 * torch.randn(b, n, h, 64, generator=gen, device="cuda"))
                   .to(torch.bfloat16) for _ in range(3))
    sma.reset_launch_counts()
    got = sma.small_attention(q, k, v, 0.125)
    assert sma.launch_counts() == {"small_attention": 1}
    _close(got, sma.small_attention_reference(q, k, v, 0.125))


def test_small_attention_autograd(gen):
    q, k, v = (torch.randn(2, 512, 2, 64, generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    do = torch.randn(2, 512, 2, 64, generator=gen, device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(sma.small_attention(q, k, v, 0.125), (q, k, v), do)
    want = torch.autograd.grad(sma.small_attention_reference(q, k, v, 0.125), (q, k, v), do)
    for g, r in zip(got, want):
        _close(g, r)
    with pytest.raises(ValueError):
        sma.small_attention(q[:, :100].detach(), k[:, :100].detach(), v[:, :100].detach(), 0.125)


@pytest.mark.parametrize("dtype,shape,groups", [(torch.bfloat16, (2, 192, 64, 64), 32),
                                                (torch.float32, (3, 64, 24, 40), 8)])
def test_group_norm_silu_kernels_match_plain(gen, dtype, shape, groups):
    c = shape[1]
    x = (2 * torch.randn(*shape, generator=gen, device="cuda") + 1).to(dtype)
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    fnorm.reset_launch_counts()
    got = fnorm.group_norm_silu(x, scale, bias, groups)
    assert fnorm.launch_counts() == {"group_norm_stats": 1, "group_norm_apply": 1}
    assert got.dtype == dtype
    _close(got, fnorm.group_norm_silu_reference(x, scale, bias, groups))
    # The stats are fp32 sums: held to fp32, each within 1e-5 relative.
    stats, want = fnorm.group_stats(x, groups), fnorm.group_stats_reference(x, groups)
    assert ((stats - want).abs() <= 1e-5 * want.abs()).all()
