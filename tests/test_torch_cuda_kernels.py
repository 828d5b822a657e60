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
from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab

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
            assert fab.launch_counts()["attention_core"] == 6  # stages 2-4, enc + dec
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
