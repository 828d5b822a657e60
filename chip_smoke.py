#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases, as a check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --profile       # also torch.profiler breakdowns
    python3 chip_smoke.py --phases build,kernels --baseline DIR [DIR ...]
                                          # also time the wgmma kernels
                                          # (WGMMA_KERNELS) built from each
                                          # DIR's deepl_project_tpu_torch/csrc

Phases (any failure exits non-zero and prints no result):

1. build: compile the Hopper kernel sources of deepl_project_tpu_torch/csrc
   (nine launchers in seven files) with nvcc for sm_90a, all in parallel, and
   print ptxas' register and shared memory report (in full for the five
   wgmma/TMA kernels, WGMMA_KERNELS).
2. kernels: run each kernel at the main paths' shapes and hold it against
   its plain PyTorch version on the same inputs: max |kernel - plain| <=
   2**-6 * max|plain|, i.e. two bf16 rounding steps (ulp <= 2**-7 |v|) at
   the largest magnitude. The sublayer kernels at large f16d32 @256px,
   batch 32 ([B,4096,384] for ln_qkv_rope; [B,1024,768] and [B,256,1536]
   for all three); the flash kernels (forward; the backward's dq, dk and dv,
   run twice to bound dq's run-to-run difference, which its L2 reductions in
   a run-dependent order allow, and twice more under
   torch.use_deterministic_algorithms(True), where the deterministic
   launcher must give bit-equal results; its time and memory are logged) at
   the training microbatch (8 images, 6 heads, N=4096), the forward also at
   512px serving (2 images, N=16384), at 256px serving batch 32 against the
   plain chunked core (the inference dispatch's evidence) and at the 1024px
   sweep's stage 2 (4 images, N=65536); small_attention
   at the 512px stage-4 shape (8 images, N=1024, 24 heads, q/k/v slices of
   one [B, N, 3C] buffer as ln_qkv_rope leaves them); group_norm_silu (stats
   and apply kernels) at the large f16d32 ResBlock shapes at b32,
   [32, 192, 256, 256] and [32, 192, 128, 128] bf16, the stats kernel's fp32
   sums each within 1e-5 relative of the plain fp32 sums. Times each kernel,
   its plain version and, where one exists, the one PyTorch call computing
   the same function (SDPA, its backward, F.linear, torch.var_mean for the
   GroupNorm stats; F.group_norm + F.silu for the whole group_norm_silu),
   with CUDA events (proj_bias_gemm and F.linear on the same bf16 weight,
   cast once as the model caches it); and the two routes of an attention
   sublayer at (N=1024, C=1536, b=8): the whole-sublayer kernels against
   ln_qkv_rope + small_attention + the projection. With --baseline DIR ...,
   proj_bias_gemm (both shapes), small_attention, the flash forward (the
   four flash shapes above), attention_core (both sublayer shapes) and the
   flash backward (DIR's flash_attention_bwd, or its flash_attention_bwd_dq
   + flash_attention_bwd_dkv pair behind the plain delta) are also built
   from each DIR's sources that exist and each build timed beside this
   tree's on the same inputs in turns (baseline, this tree, this tree,
   baseline).
3. grad: the sublayer kernels' backward (their plain versions' VJP) at the
   stage-3 training shape: gradients of x, the LN affines and every weight
   on the kernel path against the plain path's.
4. train: large f16d32 (fp32 params from a seed, bf16 compute) trained by
   Trainer.fit on synthetic 256px images, batch 16 as 2 microbatches of 8,
   L1 + LPIPS (random VGG) + KL, AdamW with warmup, a checkpoint at the
   end; launch counters set to 0 before and read after: exactly 12 flash
   forward and 12 flash backward launches per step and no other kernel;
   finite losses, params moved; one batch's loss and gradient norm on the
   kernel path against the plain attention core. Times steps, img/s and
   peak memory.
5. serve: build large f16d32 in bf16 from a seed, serve it over HTTP on
   localhost through InferenceEngine (concurrent uint8/float reconstruct,
   encode and decode requests), with the launch counters set to 0 before and
   read after; check shapes, finiteness and the [0,1] range; check one
   reconstruct's launches per kernel and shape; hold one reconstruct (b=4)
   of the kernel path and of the plain bf16 path against the same weights
   in fp32; one 512px reconstruct (b=2) with its flash forward launches.
6. time: reconstruct images/s at batch 32 through InferenceEngine.run.
7. eval: evaluate_model at 256px on the shapes source (2 batches of 16, LPIPS
   and vgg_rfid on random VGG); extrapolation_sweep at 256/512/1024px on 8
   shapes images made at 1024px (chunks of 8, 8 and 4), with the launch
   counters set to 0 before and read after each resolution: at 512px 12
   small_attention and 12 + 6 + 8 ln_qkv_rope per chunk and no sublayer
   kernel, at 1024px 6 + 8 + 12 flash forwards and no small_attention;
   finite PSNR/SSIM, images/s and peak memory per resolution; one 512px
   reconstruct (b=2) of the kernel path and of the plain bf16 path against
   fp32 (the serve phase's rule); cli/generate.py --mode random on the card.
   With --profile, a torch.profiler table of one 1024px chunk's reconstruct
   (as the train and time phases profile one step and one reconstruct).

Launches are checked against one table per resolution (256, 512, 1024px;
launches_per_reconstruct); group_norm_silu, on no model path, must show no
launch in the train, serve and eval runs. The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

# H100 SXM dense peaks (NVIDIA data sheet) for the bound of each kernel:
# bf16 tensor cores, fp32 outside the tensor cores (elementwise work), HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_RTOL = 2 ** -6
# group_norm_stats' fp32 sums (~4e5 values a group) against the plain fp32
# sums: two summation orders differ by ~1e-6 relative; a chunk left out would
# move a sum by far more.
STATS_RTOL = 1e-5
# Whole-model check: the kernel path and the plain bf16 path round at
# different places in 26 attention sublayers, and a random-weight model
# carries each rounding difference through the decoder, so neither is held to
# the other; both are held to the fp32 computation, and the kernel path must
# be about as close to it as the plain bf16 path.
MODEL_MEAN_RATIO = 1.5
MODEL_MAX_RATIO = 2.0
# Training: the flash path and the plain attention core round at different
# places in 6 stage-2 sublayers of a bf16 model; on the same weights and
# images (the mean decoded, no sampling noise) their losses must agree to 1%
# and their gradient norms to 5%.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 5e-2
TRAIN_STEPS = 5
COMPARE_BATCH = 4  # the plain core's saved [B, h, N, N] weights bound it
# (batch, N, heads) of the flash kernels' shapes: the training microbatch,
# 256px serving at batch 32 (stage 2), 512px serving at batch 2 and the
# 1024px sweep's chunk of 4 (stage 2).
FLASH_TRAIN = (8, 4096, 6)
FLASH_SERVE_256 = (32, 4096, 6)
FLASH_SERVE_512 = (2, 16384, 6)
FLASH_SWEEP_1024 = (4, 65536, 6)
# small_attention at 512px stage 4, (batch, N, heads); group_norm_silu at the
# large f16d32 ResBlock shapes (stages 0 and 1) at b32.
SMALL_512 = (8, 1024, 24)
GROUP_NORM_SHAPES = ((32, 192, 256, 256), (32, 192, 128, 128))
# extrapolation_sweep: resolution -> images per forward (chunk).
EVAL_CHUNKS = {256: 8, 512: 8, 1024: 4}
EVAL_IMAGES = 8

# The kernels built on wgmma and TMA (csrc/hopper_tma_wgmma.cuh).
WGMMA_KERNELS = ("proj_bias_gemm", "small_attention", "flash_attention_bwd",
                 "flash_attention_fwd", "attention_core")
# The flash backward of checkouts from before its single pass: two
# launchers, built by --baseline from such a DIR with these signatures.
PAIR_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = ""


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around ``iters`` calls. A sleep
    kernel ahead of them (~1.5 ms of clocks a call) keeps the card busy
    while the host enqueues, so the calls run back to back and a slow or
    shared host does not enter the time (it would for calls shorter than
    their Python and launch overhead)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(3_000_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 -------------------------------------------------------------
def phase_build():
    from deepl_project_tpu_torch.ops.hopper import build

    t = time.time()
    paths = build.build()
    log(f"built {sorted(paths)} in {time.time() - t:.1f}s")
    for name, text in build.BUILD_LOGS.items():
        whole = name in WGMMA_KERNELS
        for line in text.splitlines():
            if whole or "registers" in line or "spill" in line or "warning" in line:
                log(f"ptxas {name}: {line.strip()}")


# -- phase 2 -------------------------------------------------------------
def kernel_shapes():
    """(N, C, height, width, batch) of the main path's attention stages."""
    return [(4096, 384, 64, 64, 32), (1024, 768, 32, 32, 32), (256, 1536, 16, 16, 32)]


def launches_per_reconstruct(res: int = 256, forwards: int = 1) -> tuple[dict, dict, dict, dict]:
    """Launches of large f16d32's kernels in ``forwards`` reconstructs at
    ``res`` px, in kernel_launches' order: sublayer kernels by (name, N, C),
    flash forwards by (name, N, heads), small_attention by (name, N, heads),
    group_norm_silu's kernels (none: no model path calls them). Stages 2-4
    hold 3, 4 and 6 blocks, each in the encoder and the decoder: 6, 8 and 12
    attention sublayers."""
    sub = ("ln_qkv_rope", "attention_core", "proj_bias_gemm")
    table = {
        # Stage 2 (4096, 384): ln_qkv_rope + flash forward; stages 3
        # (1024, 768) and 4 (256, 1536): the whole-sublayer kernels.
        256: ({("ln_qkv_rope", 4096, 384): 6, **{(k, 1024, 768): 8 for k in sub},
               **{(k, 256, 1536): 12 for k in sub}},
              {("flash_attention_fwd", 4096, 6): 6}, {}),
        # ln_qkv_rope everywhere; flash forwards at stages 2-3, and at stage 4
        # (1024, 1536), where the sublayer gate refuses, small_attention.
        512: ({("ln_qkv_rope", 16384, 384): 6, ("ln_qkv_rope", 4096, 768): 8,
               ("ln_qkv_rope", 1024, 1536): 12},
              {("flash_attention_fwd", 16384, 6): 6, ("flash_attention_fwd", 4096, 12): 8},
              {("small_attention", 1024, 24): 12}),
        1024: ({("ln_qkv_rope", 65536, 384): 6, ("ln_qkv_rope", 16384, 768): 8,
                ("ln_qkv_rope", 4096, 1536): 12},
               {("flash_attention_fwd", 65536, 6): 6, ("flash_attention_fwd", 16384, 12): 8,
                ("flash_attention_fwd", 4096, 24): 12}, {}),
    }
    return tuple({k: v * forwards for k, v in d.items()} for d in table[res]) + ({},)


def kernel_launches() -> tuple[dict, dict, dict, dict]:
    """Launches by shape since the last reset, in launches_per_reconstruct's
    order."""
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma

    return (fab.launch_counts_by_shape(), fla.launch_counts_by_shape(),
            sma.launch_counts_by_shape(), fnorm.launch_counts_by_shape())


def norm_launches() -> dict:
    """group_norm_silu's launches by kernel name since the last reset."""
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm

    return fnorm.launch_counts()


def reset_launches() -> None:
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma

    for mod in (fab, fla, sma, fnorm):
        mod.reset_launch_counts()


def flash_bound(name, b, n, h):
    """(flops, bytes) a flash function must do/move: its products (the
    forward's two, 4 x BH N^2 64; the backward's five, S, dP, dV, dK and dQ,
    10 x BH N^2 64), each bf16 [B, N, h, 64] operand read or written once
    and the fp32 [B, h, N] lse rows."""
    bh, d = b * h, 64
    t, row = bh * n * d * 2, bh * n * 4
    if name == "flash_attention_fwd":
        return 4 * bh * n * n * d, 4 * t + row          # q k v -> o, lse
    return 10 * bh * n * n * d, 8 * t + row             # q k v o dO lse -> dq dk dv


def bound(name, b, n, c):
    """(flops, bytes) the kernel must do/move at this shape."""
    m = b * n
    if name == "ln_qkv_rope":
        return 2 * m * c * 3 * c, m * c * 2 + 3 * c * c * 2 + 6 * c * 4 + 4 * n * 32 * 4 + 3 * m * c * 2
    if name == "attention_core":
        return 4 * b * n * n * c, 4 * m * c * 2
    return 2 * m * c * c, 2 * m * c * 2 + c * c * 2 + c * 4


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.rope import apply_rope2d

    results = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev, bf = "cuda", torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def check(name, n, c, got, ref):
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} N={n} C={c}: non-finite output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        lim = KERNEL_RTOL * top
        log(f"check {name} N={n} C={c}: max_abs_err={err:.3e} max|plain|={top:.3e} "
            f"rel={err / top:.3e} bound={lim:.3e} (rel {KERNEL_RTOL:.3e})")
        if not err <= lim:
            fail(f"{name} N={n} C={c}: max_abs_err {err:.3e} > {lim:.3e}")
        return err

    for n, c, hh, ww, b in kernel_shapes():
        nh = c // 64
        x = randn(b, n, c, dtype=bf)
        ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
        # Weights of std 2/sqrt(C): logits of std ~6, a peaked softmax.
        wq, wk, wv, wp = (randn(c, c, scale=2 / c ** 0.5) for _ in range(4))
        bp = randn(c, scale=0.1)
        packed = fab.pack_qkv(ln, wq, wk, wv)
        args = (x, ln, wq, wk, wv, hh, ww)
        q, k, v = fab.ln_qkv_rope(*args, packed=packed)
        torch.cuda.synchronize()
        ref = fab.qkv_rope_reference(*args)
        err = max(check("ln_qkv_rope", n, c, t, r) for t, r in zip((q, k, v), ref))
        rec = {"ln_qkv_rope": {"err": err}}
        rec["ln_qkv_rope"]["ms"] = cuda_time_ms(lambda: fab.ln_qkv_rope(*args, packed=packed), 20)
        rec["ln_qkv_rope"]["plain_ms"] = cuda_time_ms(lambda: fab.qkv_rope_reference(*args), 5)
        rec["ln_qkv_rope"]["library_ms"] = None  # no single PyTorch call
        if n <= fab.MAX_SUBLAYER_TOKENS:
            scale = 64 ** -0.5
            o = fab.attention_core(q, k, v, scale)
            torch.cuda.synchronize()
            err = check("attention_core", n, c, o, fab.attention_core_reference(q, k, v, scale))
            heads = [t.reshape(b, n, nh, 64).transpose(1, 2) for t in (q, k, v)]
            rec["attention_core"] = {
                "err": err,
                "ms": cuda_time_ms(lambda: fab.attention_core(q, k, v, scale), 20),
                "plain_ms": cuda_time_ms(lambda: fab.attention_core_reference(q, k, v, scale), 5),
                "library_ms": cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(*heads), 20)}
            o = o.contiguous()
            # The weight cast once, as AttentionRoPE caches it: the kernel and
            # F.linear are timed on the same bf16 weight.
            wpk, bpk = fab.pack_proj(wp, bp)
            bpb = bp.to(bf)
            out = fab.proj_bias_gemm(o, wpk, bpk)
            torch.cuda.synchronize()
            err = check("proj_bias_gemm", n, c, out, fab.proj_bias_reference(o, wp, bp))
            rec["proj_bias_gemm"] = {
                "err": err,
                "ms": cuda_time_ms(lambda: fab.proj_bias_gemm(o, wpk, bpk), 20),
                "plain_ms": cuda_time_ms(lambda: fab.proj_bias_reference(o, wp, bp), 5),
                "library_ms": cuda_time_ms(lambda: F.linear(o, wpk, bpb), 20)}
            # Row 1 as a whole, and its library composition for comparison.
            sub = (x, ln, wq, wk, wv, wp, bp, hh, ww)
            full = fab.fused_attention_sublayer(*sub, packed=packed, packed_proj=(wpk, bpk))
            torch.cuda.synchronize()
            check("fused_attention_sublayer", n, c, full, fab.sublayer_reference(*sub))
            wb = [w.to(bf) for w in (wq, wk, wv)]

            def library_sublayer():
                t = [F.linear(F.layer_norm(x, (c,), g.to(bf), bb.to(bf)), w).reshape(b, n, nh, 64)
                     for (g, bb), w in zip(ln, wb)]
                qh, kh = (apply_rope2d(u, hh, ww) for u in t[:2])
                a = F.scaled_dot_product_attention(
                    *(u.transpose(1, 2) for u in (qh, kh, t[2])))
                return F.linear(a.transpose(1, 2).reshape(b, n, c), wpk, bpb)

            sub_ms = cuda_time_ms(lambda: fab.fused_attention_sublayer(
                *sub, packed=packed, packed_proj=(wpk, bpk)), 20)
            lib_ms = cuda_time_ms(library_sublayer, 20)
            log(f"time fused_attention_sublayer N={n} C={c} b={b}: kernels "
                f"{sub_ms:.4f} ms, library composition (cuBLAS + SDPA) "
                f"{lib_ms:.4f} ms [{CARD}]")
        for name, r in rec.items():
            flops, nbytes = bound(name, b, n, c)
            r["flops"], r["bytes"] = flops, nbytes
            r["bound_ms"] = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {name} N={n} C={c} b={b}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
                f"{r['bound_ms']:.4f} ms ({flops:.4e} FLOP, {nbytes:.4e} B) [{CARD}]")
            results[(name, n, c)] = r
    return results


def phase_flash_kernels():
    """The flash forward and backward against their plain versions; times."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.attention import xla_attention
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    scale = 64 ** -0.5

    def inputs(b, n, h):
        # Entries of std 1.5: scores q.k/8 of std ~1.1, a spread softmax row.
        return [(1.5 * torch.randn(b, n, h, 64, generator=gen, device="cuda"))
                .to(torch.bfloat16) for _ in range(4)]

    def check(name, shape, got, ref):
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: non-finite output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        lim = KERNEL_RTOL * top
        log(f"check {name} (B, N, h)={shape}: max_abs_err={err:.3e} max|plain|={top:.3e} "
            f"rel={err / top:.3e} bound={lim:.3e} (rel {KERNEL_RTOL:.3e})")
        if not err <= lim:
            fail(f"{name} {shape}: max_abs_err {err:.3e} > {lim:.3e}")
        return err

    def record(name, shape, err, ms, plain_ms, library_ms):
        flops, nbytes = flash_bound(name, *shape)
        r = {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "flops": flops, "bytes": nbytes,
             "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3}
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        log(f"time {name} (B, N, h)={shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({flops:.4e} FLOP, "
            f"{nbytes:.4e} B) [{CARD}]")
        results[(name, *shape)] = r

    results = {}
    # Training microbatch: forward and backward.
    shape = FLASH_TRAIN
    q, k, v, do = inputs(*shape)
    o, lse = fla.flash_forward(q, k, v, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fla.flash_forward_reference(q, k, v, scale)
    err = max(check("flash_attention_fwd", shape, o, o_ref),
              check("flash_attention_fwd lse", shape, lse, lse_ref))
    del o_ref, lse_ref
    # The backward twice on the same inputs: dq's fp32 partial sums reach L2
    # in a run-dependent order, so the two dq may differ (bounded like the
    # error); dk and dv are summed in registers and must be bit-equal.
    first = fla.flash_backward(q, k, v, o, lse, do, scale)
    second = fla.flash_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    ref = fla.flash_backward_reference(q, k, v, o, lse, do, scale)
    err_bwd = max(check(f"flash_attention_bwd {nm}", shape, g, r)
                  for nm, g, r in zip(("dq", "dk", "dv"), first, ref))
    rerun = (first[0].float() - second[0].float()).abs().max().item()
    top = ref[0].float().abs().max().item()
    log(f"check flash_attention_bwd (B, N, h)={shape}: dq run-to-run max_abs_diff={rerun:.3e} "
        f"({(first[0] != second[0]).sum().item()} of {first[0].numel()} values differ; bound "
        f"{KERNEL_RTOL * top:.3e}); dk, dv bit-equal: "
        f"{torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])}")
    if not (rerun <= KERNEL_RTOL * top and torch.equal(first[1], second[1])
            and torch.equal(first[2], second[2])):
        fail("flash_attention_bwd: two runs on the same inputs differ beyond the bound")
    # Under torch.use_deterministic_algorithms(True): the deterministic
    # launcher, two runs bit-equal, within the bound of the plain version;
    # its time and the device memory one call adds.
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        det = [fla.flash_backward(q, k, v, o, lse, do, scale)]
        torch.cuda.synchronize()
        det_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        det.append(fla.flash_backward(q, k, v, o, lse, do, scale))
        det_ms = cuda_time_ms(lambda: fla.flash_backward(q, k, v, o, lse, do, scale), 20)
    finally:
        torch.use_deterministic_algorithms(was)
    same = all(torch.equal(a, b) for a, b in zip(*det))
    log(f"check flash_attention_bwd deterministic (B, N, h)={shape}: two runs bit-equal "
        f"(dq, dk, dv): {same}; one call's peak device memory above its inputs "
        f"{det_gib:.3f} GiB")
    err_det = max(check(f"flash_attention_bwd_det {nm}", shape, g, r)
                  for nm, g, r in zip(("dq", "dk", "dv"), det[0], ref))
    if not same:
        fail("flash_attention_bwd_det: two runs on the same inputs are not bit-equal")
    del first, second, ref, det
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 20)
    hq = [t.detach().requires_grad_(True) for t in heads]
    out = F.scaled_dot_product_attention(*hq)
    g = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_time_ms(
        lambda: torch.autograd.grad(out, hq, g, retain_graph=True), 20)
    del out, hq
    plain_fwd_ms = cuda_time_ms(lambda: fla.flash_forward_reference(q, k, v, scale), 3)
    plain_bwd_ms = cuda_time_ms(
        lambda: fla.flash_backward_reference(q, k, v, o, lse, do, scale), 3)
    record("flash_attention_fwd", shape, err,
           cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 20), plain_fwd_ms, sdpa_ms)
    # The whole flash_backward call (delta, the pass, dq's rounding) beside
    # SDPA's backward, which also includes its own preprocess and rounding.
    record("flash_attention_bwd", shape, err_bwd,
           cuda_time_ms(lambda: fla.flash_backward(q, k, v, o, lse, do, scale), 20),
           plain_bwd_ms, sdpa_bwd_ms)
    row = results[("flash_attention_bwd", *shape)]
    row.update(rerun_max_abs_diff=rerun, det_ms=det_ms, det_max_abs_err=err_det,
               det_peak_gib=det_gib)
    log(f"time flash_attention_bwd (B, N, h)={shape}: default {row['ms']:.4f} ms, "
        f"deterministic {det_ms:.4f} ms [{CARD}]")
    del q, k, v, do, o, lse

    # Serving: 512px stage 2, and the 256px stage-2 decision (flash forward
    # against the plain chunked core, in turns: plain, kernel, kernel, plain).
    for shape in (FLASH_SERVE_512, FLASH_SERVE_256):
        q, k, v, _ = inputs(*shape)
        o, _ = fla.flash_forward(q, k, v, scale)
        torch.cuda.synchronize()
        plain = xla_attention(q, k, v, scale)
        err = check("flash_attention_fwd", shape, o, plain)
        del o, plain
        t_plain = [cuda_time_ms(lambda: xla_attention(q, k, v, scale), 3)]
        t_kern = [cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 10) for _ in range(2)]
        t_plain.append(cuda_time_ms(lambda: xla_attention(q, k, v, scale), 3))
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 10)
        log(f"serve core (B, N, h)={shape}: flash forward {t_kern[0]:.4f} / {t_kern[1]:.4f} ms, "
            f"plain chunked core {t_plain[0]:.4f} / {t_plain[1]:.4f} ms [{CARD}]")
        record("flash_attention_fwd", shape, err, min(t_kern), min(t_plain), sdpa_ms)
        del q, k, v, heads

    # The 1024px sweep's stage 2: once against the plain forward (its one
    # call timed by events), then the kernel and SDPA.
    shape = FLASH_SWEEP_1024
    q, k, v, _ = inputs(*shape)
    o, lse = fla.flash_forward(q, k, v, scale)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    o_ref, lse_ref = fla.flash_forward_reference(q, k, v, scale)
    end.record()
    torch.cuda.synchronize()
    err = max(check("flash_attention_fwd", shape, o, o_ref),
              check("flash_attention_fwd lse", shape, lse, lse_ref))
    del o, lse, o_ref, lse_ref
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    record("flash_attention_fwd", shape, err,
           cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 3), start.elapsed_time(end),
           cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 3))
    del q, k, v, heads
    torch.cuda.empty_cache()
    return results


def phase_eval_kernels():
    """small_attention and group_norm_silu against their plain versions at
    the shapes their paths give them; times; and the two routes of an
    attention sublayer at (N=1024, C=1536)."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf = torch.bfloat16
    results = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def check(name, shape, got, ref):
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: non-finite output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        lim = KERNEL_RTOL * top
        log(f"check {name} {shape}: max_abs_err={err:.3e} max|plain|={top:.3e} "
            f"rel={err / top:.3e} bound={lim:.3e} (rel {KERNEL_RTOL:.3e})")
        if not err <= lim:
            fail(f"{name} {shape}: max_abs_err {err:.3e} > {lim:.3e}")
        return err

    def check_fp32(name, shape, got, ref):
        """An fp32 result, each value within STATS_RTOL of the plain one's."""
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: non-finite output")
        err = (got - ref).abs()
        rel = (err / ref.abs()).max().item()
        log(f"check {name} {shape}: max_abs_err={err.max().item():.3e} max "
            f"rel={rel:.3e} bound rel {STATS_RTOL:.1e} (fp32)")
        if not rel <= STATS_RTOL:
            fail(f"{name} {shape}: max rel err {rel:.3e} > {STATS_RTOL:.1e}")
        return err.max().item()

    def record(key, err, ms, plain_ms, library_ms, flops, nbytes, peak):
        r = {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "flops": flops, "bytes": nbytes,
             "bound_ms": max(flops / peak, nbytes / PEAK_HBM_BYTES) * 1e3,
             "bound_by": "operations" if flops / peak >= nbytes / PEAK_HBM_BYTES else "bytes"}
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        log(f"time {key[0]} {key[1:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib} ms, bound {r['bound_ms']:.4f} ms ({flops:.4e} FLOP, {nbytes:.4e} B) [{CARD}]")
        results[key] = r

    # small_attention at 512px stage 4: q/k/v are column slices of one
    # [B, N, 3C] buffer, as ln_qkv_rope leaves them. Entries of std 1.5:
    # scores q.k/8 of std ~1.1, a spread softmax row.
    b, n, h = SMALL_512
    c = h * 64
    qkv = randn(b, n, 3 * c, scale=1.5).to(bf)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, 64) for i in range(3))
    scale = 64 ** -0.5
    o = sma.small_attention(q, k, v, scale)
    torch.cuda.synchronize()
    err = check("small_attention", SMALL_512, o, sma.small_attention_reference(q, k, v, scale))
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    record(("small_attention", *SMALL_512), err,
           cuda_time_ms(lambda: sma.small_attention(q, k, v, scale), 20),
           cuda_time_ms(lambda: sma.small_attention_reference(q, k, v, scale), 5),
           cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 20),
           4 * b * h * n * n * 64, 4 * b * n * c * 2, PEAK_BF16_FLOPS)
    del qkv, q, k, v, o, heads

    # group_norm_silu at the large ResBlock shapes: the stats kernel reads x
    # once (3 fp32 operations a value), the apply kernel reads x and writes y
    # (about 8: an affine, exp, add, divide); both bound by bytes.
    for shape in GROUP_NORM_SHAPES:
        bb, cc, hh, ww = shape
        x = (randn(*shape, scale=2.0) + 1).to(bf)
        gs, gb = 1 + randn(cc, scale=0.1), randn(cc, scale=0.1)
        y = fnorm.group_norm_silu(x, gs, gb, 32)
        stats = fnorm.group_stats(x, 32)
        torch.cuda.synchronize()
        err = check("group_norm_silu", shape, y, fnorm.group_norm_silu_reference(x, gs, gb, 32))
        err_stats = check_fp32("group_norm_stats", shape, stats,
                               fnorm.group_stats_reference(x, 32))
        mul, add = fnorm.mul_add(stats, (cc // 32) * hh * ww, gs, gb, 1e-5)
        err_apply = check("group_norm_apply", shape, fnorm.apply(x, mul, add),
                          fnorm.apply_reference(x, mul, add))
        # Library calls, timed only: F.group_norm + F.silu for the whole
        # function; for the stats pass the one call computing the same
        # per-group reduction; none for the apply pass alone.
        gsb, gbb = gs.to(bf), gb.to(bf)
        lib_ms = cuda_time_ms(lambda: F.silu(F.group_norm(x, 32, gsb, gbb)), 10)
        var_mean_ms = cuda_time_ms(
            lambda: torch.var_mean(x.view(bb, 32, -1), dim=-1, correction=0), 10)
        whole = cuda_time_ms(lambda: fnorm.group_norm_silu(x, gs, gb, 32), 10)
        log(f"time group_norm_silu {shape} bf16 whole (2 kernels + epilogue): {whole:.4f} ms, "
            f"plain {cuda_time_ms(lambda: fnorm.group_norm_silu_reference(x, gs, gb, 32), 3):.4f} "
            f"ms, F.group_norm + F.silu {lib_ms:.4f} ms [{CARD}]")
        values, xbytes = x.numel(), x.numel() * 2
        record(("group_norm_stats", *shape), err_stats,
               cuda_time_ms(lambda: fnorm.group_stats(x, 32), 10),
               cuda_time_ms(lambda: fnorm.group_stats_reference(x, 32), 3),
               var_mean_ms, 3 * values, xbytes + bb * 32 * 2 * 4, PEAK_FP32_FLOPS)
        record(("group_norm_apply", *shape), max(err, err_apply),
               cuda_time_ms(lambda: fnorm.apply(x, mul, add), 10),
               cuda_time_ms(lambda: fnorm.apply_reference(x, mul, add), 3),
               None, 8 * values, 2 * xbytes + 2 * bb * cc * 4, PEAK_FP32_FLOPS)
        results[("group_norm_silu", *shape)] = {"ms": whole, "library_ms": lib_ms}
        del x, y
    torch.cuda.empty_cache()

    # The two routes of a sublayer at (N=1024, C=1536, b=8), in turns: the
    # whole-sublayer kernels (the route the JAX gate refuses at this shape)
    # against ln_qkv_rope + small_attention + the projection (its route).
    b, n, c, hh, ww = 8, 1024, 1536, 32, 32
    x = randn(b, n, c).to(bf)
    ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
    wq, wk, wv, wp = (randn(c, c, scale=2 / c ** 0.5) for _ in range(4))
    bp = randn(c, scale=0.1)
    packed, packed_proj = fab.pack_qkv(ln, wq, wk, wv), fab.pack_proj(wp, bp)
    wpb, bpb = wp.to(bf), bp.to(bf)

    def sublayer():
        return fab.fused_attention_sublayer(x, ln, wq, wk, wv, wp, bp, hh, ww, packed=packed,
                                            packed_proj=packed_proj)

    def qkv_small_proj():
        q, k, v = (t.reshape(b, n, c // 64, 64)
                   for t in fab.ln_qkv_rope(x, ln, wq, wk, wv, hh, ww, packed=packed))
        return F.linear(sma.small_attention(q, k, v, 64 ** -0.5).reshape(b, n, c), wpb, bpb)

    a, s2 = sublayer(), qkv_small_proj()
    torch.cuda.synchronize()
    check("route ln_qkv_rope+small_attention+proj vs sublayer", (b, n, c), s2, a)
    t_sub = [cuda_time_ms(sublayer, 20)]
    t_small = [cuda_time_ms(qkv_small_proj, 20) for _ in range(2)]
    t_sub.append(cuda_time_ms(sublayer, 20))
    log(f"time sublayer routes (N, C, b)=({n}, {c}, {b}): whole-sublayer kernels "
        f"{t_sub[0]:.4f} / {t_sub[1]:.4f} ms, ln_qkv_rope + small_attention + proj "
        f"{t_small[0]:.4f} / {t_small[1]:.4f} ms [{CARD}]")
    results[("routes", n, c)] = {"sublayer_ms": min(t_sub), "small_route_ms": min(t_small)}
    del x, a, s2
    torch.cuda.empty_cache()
    return results


def phase_baseline(dirs):
    """proj_bias_gemm, small_attention, the flash backward, the flash forward
    and attention_core of this tree against the same functions built from
    other checkouts' sources
    (DIR/deepl_project_tpu_torch/csrc for each DIR), each launched through
    its ctypes launcher on the same inputs at the main paths' shapes; all
    held to the plain version; each DIR timed beside this tree in turns
    (DIR, change, change, DIR). A DIR from before the single-pass backward
    has the flash_attention_bwd_dq + flash_attention_bwd_dkv pair instead: it
    is timed with the plain delta it was given (the device work of that
    tree's flash_backward) against this tree's launcher, which computes delta
    itself. Returns kernel name -> DIR -> shape -> times."""
    import ctypes
    from pathlib import Path

    import torch

    from deepl_project_tpu_torch.ops.hopper import build
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma

    P, I = ctypes.c_void_p, ctypes.c_int
    pair_sigs = {"flash_attention_bwd_dq": [P] * 7 + [I] * 8 + [ctypes.c_float, P],
                 "flash_attention_bwd_dkv": [P] * 8 + [I] * 8 + [ctypes.c_float, P]}
    srcs = {}
    for d in dirs:
        csrc = os.path.join(os.path.abspath(d), "deepl_project_tpu_torch", "csrc")
        if not os.path.isdir(csrc):
            fail(f"--baseline {d}: no deepl_project_tpu_torch/csrc there")
        names = [n for n in WGMMA_KERNELS + PAIR_KERNELS
                 if os.path.exists(os.path.join(csrc, f"{n}.cu"))]
        t = time.time()
        build.build(names, csrc)
        log(f"built {names} of {d} in {time.time() - t:.1f}s")
        for name in names:
            for line in build.BUILD_LOGS.get(f"{name} [{Path(csrc).resolve()}]", "").splitlines():
                if "registers" in line or "spill" in line or "C75" in line:
                    log(f"ptxas {name} ({d}): {line.strip()}")
        srcs[d] = (csrc, names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    results = {}

    def turns(name, shape, d, fns, outs, refs, flops):
        """fns: "baseline" (DIR's) and "change" (this tree's) -> a function
        launching one call; outs are compared with refs after each."""
        for who, fn in fns.items():
            for out in outs:
                out.zero_()
            fn()
            torch.cuda.synchronize()
            for out, ref in zip(outs, refs):
                top = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                if not err <= KERNEL_RTOL * top:
                    fail(f"baseline {name} {shape}: {who} max_abs_err {err:.3e} > "
                         f"{KERNEL_RTOL * top:.3e}")
        times = {"baseline": [], "change": []}
        iters = 20 if flops < 5e12 else 3  # the 1024px flash forward: ~0.1 s a call
        for who in ("baseline", "change", "change", "baseline"):
            times[who].append(cuda_time_ms(fns[who], iters))
        log(f"baseline {name} {shape}: {d} {times['baseline'][0]:.4f} / "
            f"{times['baseline'][1]:.4f} ms, change {times['change'][0]:.4f} / "
            f"{times['change'][1]:.4f} ms (turns {d}, change, change, {d}); "
            f"{flops / min(times['baseline']) / 1e9:.1f} -> "
            f"{flops / min(times['change']) / 1e9:.1f} TFLOP/s [{CARD}]")
        results.setdefault(name, {}).setdefault(d, {})[shape] = {
            w: min(v) for w, v in times.items()}

    def launch(fn, *args):
        def run():
            if fn(*args) != 0:
                fail(f"baseline: a launch failed ({fn.__name__})")
        return run

    def same_launcher(name, shape, args, outs, refs, flops):
        for d, (csrc, names) in srcs.items():
            if name in names:
                turns(name, shape, d, {"baseline": launch(build.launcher(name, csrc), *args),
                                       "change": launch(build.launcher(name), *args)},
                      outs, refs, flops)

    for n, c, _, _, b in kernel_shapes()[1:]:
        o = torch.randn(b * n, c, generator=gen, device="cuda").to(bf)
        wp = torch.randn(c, c, generator=gen, device="cuda") * 2 / c ** 0.5
        bp = torch.randn(c, generator=gen, device="cuda") * 0.1
        wpk, bpk = fab.pack_proj(wp, bp)
        out = torch.empty_like(o)
        args = (o.data_ptr(), wpk.data_ptr(), bpk.data_ptr(), out.data_ptr(), b * n, c, c,
                stream)
        same_launcher("proj_bias_gemm", (b, n, c), args, [out],
                      [fab.proj_bias_reference(o, wp, bp)], 2 * b * n * c * c)
    b, n, h = SMALL_512
    c = h * 64
    qkv = (1.5 * torch.randn(b, n, 3 * c, generator=gen, device="cuda")).to(bf)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, 64) for i in range(3))
    o = torch.empty(b, n, h, 64, device="cuda", dtype=bf)
    scale = 64 ** -0.5
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, 3 * c, 3 * c,
            3 * c, c, scale, stream)
    same_launcher("small_attention", SMALL_512, args, [o],
                  [sma.small_attention_reference(q, k, v, scale)], 4 * b * h * n * n * 64)
    del qkv, q, k, v, o

    # The forward tile: flash_attention_fwd at its four shapes (training,
    # serving at 256 and 512px, the 1024px sweep), attention_core at the two
    # sublayer shapes with q/k/v column slices of one [B, N, 3C] buffer.
    for b, n, h in (FLASH_TRAIN, FLASH_SERVE_256, FLASH_SERVE_512, FLASH_SWEEP_1024):
        c = h * 64
        q, k, v = ((1.5 * torch.randn(b, n, h, 64, generator=gen, device="cuda")).to(bf)
                   for _ in range(3))
        o, lse = torch.empty_like(q), torch.empty(b, h, n, device="cuda")
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, h,
                c, c, c, c, scale, stream)
        same_launcher("flash_attention_fwd", (b, n, h), args, [o, lse],
                      list(fla.flash_forward_reference(q, k, v, scale)),
                      flash_bound("flash_attention_fwd", b, n, h)[0])
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    for n, c, _, _, b in kernel_shapes()[1:]:
        qkv = (1.5 * torch.randn(b, n, 3 * c, generator=gen, device="cuda")).to(bf)
        q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
        o = torch.empty(b, n, c, device="cuda", dtype=bf)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, c // 64, 3 * c, c,
                scale, stream)
        same_launcher("attention_core", (b, n, c), args, [o],
                      [fab.attention_core_reference(q, k, v, scale)], 4 * b * n * n * c)
        del qkv, q, k, v, o

    # The flash backward at the training microbatch.
    b, n, h = FLASH_TRAIN
    c = h * 64
    q, k, v, do = ((1.5 * torch.randn(b, n, h, 64, generator=gen, device="cuda")).to(bf)
                   for _ in range(4))
    o, lse = fla.flash_forward(q, k, v, scale)
    refs = fla.flash_backward_reference(q, k, v, o, lse, do, scale)
    outs = [torch.empty_like(q) for _ in range(3)]
    delta = torch.empty(b, h, n, device="cuda")
    acc = torch.empty(b, h, n, 64, device="cuda")
    flops = flash_bound("flash_attention_bwd", b, n, h)[0]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), acc.data_ptr(), *(t.data_ptr() for t in outs),
            b, n, h, c, c, c, c, c, c, scale, stream)
    same_launcher("flash_attention_bwd", FLASH_TRAIN, args, outs, refs, flops)
    for d, (csrc, names) in srcs.items():
        if not set(PAIR_KERNELS) <= set(names):
            continue
        dq_fn, dkv_fn = (build.launcher(nm, csrc, pair_sigs[nm]) for nm in PAIR_KERNELS)
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr())

        def pair():
            for fn, outp in ((dq_fn, (outs[0].data_ptr(),)),
                             (dkv_fn, (outs[1].data_ptr(), outs[2].data_ptr()))):
                if fn(*common, *outp, b, n, h, c, c, c, c, c, scale, stream) != 0:
                    fail(f"baseline: the {d} flash backward pair failed to launch")

        def parent_call():
            # That tree's flash_backward on the device: the plain delta, dq, dk/dv.
            delta.copy_((do.float() * o.float()).sum(dim=-1).transpose(1, 2))
            pair()

        turns("flash_attention_bwd", FLASH_TRAIN, d,
              {"baseline": parent_call,
               "change": launch(build.launcher("flash_attention_bwd"), *args)},
              outs, refs, flops)
        log(f"baseline flash_attention_bwd {FLASH_TRAIN}: {d}'s dq + dk/dv kernels alone "
            f"(delta given) {cuda_time_ms(pair, 20):.4f} ms [{CARD}]")
    torch.cuda.empty_cache()
    return results


def phase_grad():
    """Part of the sublayer kernels' contract since they are differentiable:
    at the stage-3 training shape (8 images, N=1024, C=768) the gradients of
    x, the LN affines and every weight through the kernel path equal the
    plain path's (the backward is the plain version's VJP)."""
    import torch

    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    b, n, c, hh, ww = 8, 1024, 768, 32, 32

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(b, n, c).to(torch.bfloat16)
    ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
    wq, wk, wv, wp = (randn(c, c, scale=2 / c ** 0.5) for _ in range(4))
    bp = randn(c, scale=0.1)
    leaves = [x, *[t for pair in ln for t in pair], wq, wk, wv, wp, bp]
    for t in leaves:
        t.requires_grad_(True)
    for kind in ("fused_attention_sublayer", "ln_qkv_rope"):
        if kind == "ln_qkv_rope":
            wrt = leaves[:-2]
            kern = lambda: torch.cat(fab.ln_qkv_rope(x, ln, wq, wk, wv, hh, ww), -1)  # noqa: E731
            plain = lambda: torch.cat(fab.qkv_rope_reference(x, ln, wq, wk, wv, hh, ww), -1)  # noqa: E731
        else:
            wrt = leaves
            kern = lambda: fab.fused_attention_sublayer(x, ln, wq, wk, wv, wp, bp, hh, ww)  # noqa: E731
            plain = lambda: fab.sublayer_reference(x, ln, wq, wk, wv, wp, bp, hh, ww)  # noqa: E731
        out = kern()
        ct = randn(*out.shape)
        got = torch.autograd.grad((out.float() * ct).sum(), wrt)
        want = torch.autograd.grad((plain().float() * ct).sum(), wrt)
        worst = 0.0
        for gk, gp in zip(got, want):
            if not bool(torch.isfinite(gk).all()):
                fail(f"grad {kind}: non-finite gradient")
            err = (gk.float() - gp.float()).abs().max().item()
            top = gp.float().abs().max().item()
            if not err <= KERNEL_RTOL * top:
                fail(f"grad {kind}: max_abs_err {err:.3e} > {KERNEL_RTOL * top:.3e}")
            worst = max(worst, err / top)
        log(f"grad {kind} N={n} C={c} b={b}: {len(wrt)} gradients match the plain "
            f"path (worst rel err {worst:.3e}, bound {KERNEL_RTOL:.3e})")


def phase_train(profile: bool):
    """Stage-1 training of large f16d32 at 256px through Trainer.fit."""
    import shutil

    import numpy as np
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.data import input_pipeline, make_dataset
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.train_step import compute_grads, global_norm

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = get_config("large", 16, 32, norm_latents=True, attention_impl="auto_train")
    weights = LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.0)
    tc = TrainerConfig(batch_size=16, accum_steps=2, warmup_steps=2, num_epochs=1,
                       steps_per_epoch=TRAIN_STEPS, log_every=1, save_every_epochs=1,
                       output_dir=out_dir, weights=weights, seed=0)
    trainer = Trainer(cfg, tc, device="cuda")
    state = trainer.create_state()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()
              if n in ("encoder.conv_in.weight", "decoder.conv_out.weight")}
    stamps = []

    def timed(it):
        for batch in it:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield batch

    data = input_pipeline(make_dataset("synthetic", resolution=256, num_samples=10 ** 6),
                          16, "cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    state = trainer.fit(timed(data), state=state)
    fit_s = time.time() - t0
    counts, sub, small, norm = (fla.launch_counts(), fab.launch_counts(),
                                kernel_launches()[2], norm_launches())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if state.step != TRAIN_STEPS:
        fail(f"train: {state.step} steps taken, {TRAIN_STEPS} asked")
    want = {k: 12 * TRAIN_STEPS for k in ("flash_attention_fwd", "flash_attention_bwd")}
    if counts != want or sub or small or norm:
        fail(f"train: flash launches {counts} (want {want}), sublayer kernel launches {sub}, "
             f"small_attention {small}, group_norm_silu {norm}")
    log(f"train: {TRAIN_STEPS} steps launched {fla.launch_counts_by_shape()} "
        f"(12 forward + 12 backward per step), no sublayer kernel, small_attention "
        f"or group_norm_silu kernel")
    counts = {**counts, **norm}
    with open(os.path.join(out_dir, "history.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["total"] for r in rows if r["kind"] == "train"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"train: losses {losses}")
    moved = {n: (p - before[n]).abs().max().item() for n, p in state.model.named_parameters()
             if n in before}
    if not all(v > 0 for v in moved.values()):
        fail(f"train: params did not move {moved}")
    steps_s = np.diff(stamps)[1:]  # the first interval includes warm-up
    step_ms = float(np.median(steps_s)) * 1e3
    log(f"train: losses {[round(v, 5) for v in losses]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in rows]}, param change {moved}")
    log(f"time train step large f16d32 @256 batch 16 (2 x 8), bf16: {step_ms:.1f} ms/step "
        f"(steps 2-{TRAIN_STEPS}: {[round(float(v) * 1e3, 1) for v in steps_s]}), "
        f"{16 / step_ms * 1e3:.2f} img/s, peak memory {peak:.2f} GiB, fit incl. "
        f"build and checkpoint {fit_s:.1f}s [{CARD}]")

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        batch = torch.as_tensor(next(data)).to("cuda")
        trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            trainer.step_fn(state, batch)
            torch.cuda.synchronize()
        table = p.key_averages().table(sort_by="cuda_time_total", row_limit=50)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "profile_train_step.txt"), "w") as f:
            f.write(f"{CARD}\n{table}\n")
        print(table, flush=True)

    # The kernel path against the plain attention core on one batch: the
    # same weights and images, the mean decoded.
    del state.optimizer
    batch = torch.as_tensor(next(data)[:COMPARE_BATCH]).to("cuda")
    attn = [m for m in state.model.modules() if isinstance(m, AttentionRoPE)]
    res = {}
    for impl in ("auto_train", "xla"):
        for m in attn:
            m.impl = impl
        fla.reset_launch_counts()
        grads, metrics = compute_grads(state.model, batch, weights, trainer.lpips_params,
                                       sample=False)
        res[impl] = (metrics["total"].item(), global_norm(grads).item(),
                     fla.launch_counts().get("flash_attention_bwd", 0))
        del grads
    (lk, gk, nk), (lp, gp, npl) = res["auto_train"], res["xla"]
    log(f"train compare ({COMPARE_BATCH} images): loss kernel path {lk:.6f} plain core "
        f"{lp:.6f} (rel {abs(lk - lp) / abs(lp):.3e}, bound {TRAIN_LOSS_RTOL}); grad norm "
        f"{gk:.6f} / {gp:.6f} (rel {abs(gk - gp) / gp:.3e}, bound {TRAIN_GRAD_NORM_RTOL})")
    if nk != 6 or npl != 0:
        fail(f"train compare: flash backward launches {nk} / {npl}, want 6 / 0")
    if not (abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp)
            and abs(gk - gp) <= TRAIN_GRAD_NORM_RTOL * gp):
        fail("train compare: the kernel path and the plain core disagree")
    del trainer, state, attn
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak}


# -- phase 3 -------------------------------------------------------------
def phase_serve(model):
    import urllib.request

    import numpy as np
    import torch

    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.serving import InferenceEngine, make_http_server

    cfg = model.config
    rng = np.random.default_rng(0)
    engine = InferenceEngine(model, max_batch=32, batch_window_ms=50.0)
    engine.start()
    server = make_http_server(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()

    def post(op, arr, dtype=None):
        import io

        buf = io.BytesIO()
        np.save(buf, arr)
        url = f"http://127.0.0.1:{port}/{op}" + (f"?dtype={dtype}" if dtype else "")
        with urllib.request.urlopen(url, data=buf.getvalue(), timeout=600) as r:
            return np.load(io.BytesIO(r.read()))

    imgs = rng.integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    lat = rng.standard_normal((4, 16, 16, cfg.latent_dim)).astype(np.float32)
    requests = ([("reconstruct", imgs[i:i + 8], "uint8") for i in range(0, 32, 8)]
                + [("reconstruct", imgs[:2].astype(np.float32) / 255.0, None),
                   ("encode", imgs[:4].astype(np.float32) / 255.0, "float16"),
                   ("decode", lat, None)])
    outs = [None] * len(requests)
    errors = []

    def worker(i):
        try:
            outs[i] = post(*requests[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(f"{requests[i][0]}: {type(e).__name__}: {e}")

    reset_launches()
    t = time.time()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    served_s = time.time() - t
    counts = {**fab.launch_counts(), **fla.launch_counts(), **norm_launches()}
    server.shutdown()
    server.server_close()
    engine.stop()
    if errors:
        fail("served requests failed: " + "; ".join(errors))
    log(f"served {len(requests)} concurrent requests in {served_s:.2f}s; "
        f"kernel launches {counts}")
    for (op, arr, dt), out in zip(requests, outs):
        want = ((arr.shape[0], 16, 16, cfg.latent_dim) if op == "encode"
                else (arr.shape[0], 256, 256, 3))
        if out.shape != want:
            fail(f"{op}: shape {out.shape} != {want}")
        o = out.astype(np.float32)
        if not np.isfinite(o).all():
            fail(f"{op}: non-finite output")
        if op != "encode" and not (o.min() >= 0 and o.max() <= (255 if dt == "uint8" else 1)):
            fail(f"{op}: output outside its range")
    for name in ("ln_qkv_rope", "attention_core", "proj_bias_gemm"):
        if counts.get(name, 0) == 0:
            fail(f"{name} was not launched while serving")

    # Exactly 20 sublayers + 6 stage-2 qkv kernels and flash forwards per
    # reconstruct.
    want = launches_per_reconstruct(256)
    reset_launches()
    kern = engine.run("reconstruct", imgs[:4])
    by_shape = kernel_launches()
    if by_shape != want:
        fail(f"launches per reconstruct {by_shape} != {want}")
    log(f"one reconstruct launched {by_shape}")

    # 512px: stages 2-3 (N=16384, 4096) take the flash forward, stage 4
    # (N=1024, C=1536) ln_qkv_rope + small_attention.
    want = launches_per_reconstruct(512)
    reset_launches()
    big = engine.run("reconstruct", rng.integers(0, 256, (2, 512, 512, 3), dtype=np.uint8))
    by_shape = kernel_launches()
    if big.shape != (2, 512, 512, 3) or not np.isfinite(big.astype(np.float32)).all():
        fail(f"512px reconstruct: shape {big.shape} or non-finite output")
    if by_shape != want:
        fail(f"512px launches per reconstruct {by_shape} != {want}")
    counts["flash_attention_fwd_512"] = sum(by_shape[1].values())
    log(f"512px reconstruct b=2: finite {big.shape}, launched {by_shape}")

    # Accuracy: the kernel path and the plain bf16 path (every attention
    # sublayer through the plain modules), each against the same weights
    # computed in fp32 on the plain path with TF32 off.
    attn = [m for m in model.modules() if isinstance(m, AttentionRoPE)]
    for m in attn:
        m.impl = "xla"
    reset_launches()
    plain = engine.run("reconstruct", imgs[:4])
    for m in attn:
        m.impl = cfg.attention_impl
    if any(kernel_launches()):
        fail("plain path launched kernels")
    with torch.device("meta"):
        twin = TransVAE(cfg.replace(dtype="float32"))
    twin = twin.to_empty(device="cuda").eval()
    twin.load_state_dict(model.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    exact = InferenceEngine(twin).run("reconstruct", imgs[:4])
    torch.backends.cudnn.allow_tf32 = tf32
    del twin
    ek, ep = np.abs(kern - exact), np.abs(plain - exact)
    log(f"reconstruct b=4 sigmoid images vs fp32: kernel path max_abs="
        f"{ek.max():.3e} mean_abs={ek.mean():.3e}; plain bf16 path max_abs="
        f"{ep.max():.3e} mean_abs={ep.mean():.3e}; kernel vs plain max_abs="
        f"{np.abs(kern - plain).max():.3e}")
    if not (ek.mean() <= MODEL_MEAN_RATIO * ep.mean()
            and ek.max() <= MODEL_MAX_RATIO * ep.max()):
        fail("reconstruct: the kernel path is less accurate than the plain bf16 path")
    return counts


# -- phase 4 -------------------------------------------------------------
def phase_time(model, profile: bool):
    import numpy as np
    import torch

    from deepl_project_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine(model, max_batch=32)
    imgs = np.random.default_rng(1).integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    engine.run("reconstruct", imgs)  # warm
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t = time.time()
    for _ in range(iters):
        engine.run("reconstruct", imgs)
    step = (time.time() - t) / iters
    log(f"time reconstruct b=32 @256px bf16: {step * 1e3:.2f} ms/batch, "
        f"{32 / step:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{CARD}]")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            engine.run("reconstruct", imgs)
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        table = p.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(out_dir, "profile_reconstruct_b32.txt"), "w") as f:
            f.write(f"{CARD}\n{table}\n")
        print(table, flush=True)
    return step


# -- phase 5 -------------------------------------------------------------
def phase_eval(model, profile: bool):
    """The evaluation slice on large f16d32: evaluate_model at 256px, the
    extrapolation sweep at 256/512/1024px with its launches, the 512px
    accuracy check, and the generate CLI; with ``profile``, a torch.profiler
    table of one 1024px chunk's reconstruct."""
    import tempfile

    import numpy as np
    import torch

    from deepl_project_tpu_torch.cli import generate
    from deepl_project_tpu_torch.data import batch_iterator, make_dataset
    from deepl_project_tpu_torch.evaluation import (evaluate_model, extrapolation_sweep,
                                                    reconstruct, resize_images)
    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE

    cfg = model.config
    out = {}

    # Reconstruction metrics at 256px: 2 batches of 16 shapes images.
    eval_dir = os.path.join(ROOT, "outputs", "chip_smoke_eval")
    torch.cuda.synchronize()
    t = time.time()
    metrics = evaluate_model(model, None, batch_iterator(make_dataset("shapes", resolution=256),
                                                         16),
                             max_batches=2, compute_rfid=True, output_dir=eval_dir,
                             save_grids=1)
    torch.cuda.synchronize()
    log(f"evaluate_model 256px shapes, 32 images, LPIPS + vgg_rfid (random VGG): "
        f"{json.dumps(metrics)} in {time.time() - t:.2f}s [{CARD}]")
    flat = [metrics[k][s] for k in ("psnr", "ssim", "lpips") for s in ("mean", "min", "max")]
    if metrics["num_images"] != 32 or not np.isfinite(flat + [metrics["vgg_rfid"]]).all():
        fail(f"evaluate_model: {metrics}")
    if sorted(os.listdir(eval_dir)) != ["comparison_000.png", "metrics.json"]:
        fail(f"evaluate_model wrote {os.listdir(eval_dir)}")

    # The extrapolation sweep, one resolution at a time so that each one's
    # launches are counted alone: a warm-up on one chunk, then all images.
    imgs = next(batch_iterator(make_dataset("shapes", resolution=1024), EVAL_IMAGES))
    sweep = {}
    for res in sorted(EVAL_CHUNKS):
        chunk = EVAL_CHUNKS[res]
        extrapolation_sweep(model, None, imgs[:chunk], (res,), chunk=chunk)
        want = launches_per_reconstruct(res, forwards=EVAL_IMAGES // chunk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        r = extrapolation_sweep(model, None, imgs, (res,), chunk=chunk)[res]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [r[s] for s in ("mean", "min", "max")] + [r["ssim"][s] for s in ("mean", "min", "max")]
        log(f"sweep {res}px ({EVAL_IMAGES} images, chunk {chunk}): psnr {r['mean']:.4f} dB "
            f"(min {r['min']:.4f}, max {r['max']:.4f}), ssim {r['ssim']['mean']:.5f}; "
            f"{EVAL_IMAGES / dt:.3f} img/s ({dt:.3f}s), peak memory {peak:.2f} GiB; "
            f"launched {got} [{CARD}]")
        if not np.isfinite(vals).all():
            fail(f"sweep {res}px: non-finite metrics {r}")
        if got != want:
            fail(f"sweep {res}px: launches {got} != {want}")
        sweep[res] = {"img_s": EVAL_IMAGES / dt, "seconds": dt, "peak_gib": peak,
                      "psnr": r["mean"], "ssim": r["ssim"]["mean"], "launches": got}
    out["sweep"] = sweep
    out["small_attention_launches"] = sum(sweep[512]["launches"][2].values())
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        chunk = imgs[:EVAL_CHUNKS[1024]]
        reconstruct(model, None, chunk)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            reconstruct(model, None, chunk)
            torch.cuda.synchronize()
        table = p.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "profile_sweep_1024.txt"), "w") as f:
            f.write(f"{CARD}\n{table}\n")
        print(table, flush=True)
    out["norm_launches"] = {}
    for s in sweep.values():
        for (name, _, _), cnt in s["launches"][3].items():
            out["norm_launches"][name] = out["norm_launches"].get(name, 0) + cnt

    # Accuracy at 512px (b=2): the kernel path (small_attention at stage 4)
    # and the plain bf16 path, each against the same weights in fp32.
    x512 = resize_images(torch.from_numpy(imgs[:2]).permute(0, 3, 1, 2), 512)
    x512 = x512.permute(0, 2, 3, 1).numpy()
    reset_launches()
    kern = reconstruct(model, None, x512)
    if kernel_launches() != launches_per_reconstruct(512):
        fail(f"512px reconstruct launched {kernel_launches()}")
    attn = [m for m in model.modules() if isinstance(m, AttentionRoPE)]
    for m in attn:
        m.impl = "xla"
    plain = reconstruct(model, None, x512)
    for m in attn:
        m.impl = cfg.attention_impl
    with torch.device("meta"):
        twin = TransVAE(cfg.replace(dtype="float32"))
    twin = twin.to_empty(device="cuda").eval()
    twin.load_state_dict(model.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    exact = reconstruct(twin, None, x512)
    torch.backends.cudnn.allow_tf32 = tf32
    del twin
    torch.cuda.empty_cache()
    ek, ep = np.abs(kern - exact), np.abs(plain - exact)
    log(f"reconstruct 512px b=2 sigmoid images vs fp32: kernel path max_abs={ek.max():.3e} "
        f"mean_abs={ek.mean():.3e}; plain bf16 path max_abs={ep.max():.3e} "
        f"mean_abs={ep.mean():.3e}; kernel vs plain max_abs={np.abs(kern - plain).max():.3e}")
    if not (ek.mean() <= MODEL_MEAN_RATIO * ep.mean()
            and ek.max() <= MODEL_MAX_RATIO * ep.max()):
        fail("512px reconstruct: the kernel path is less accurate than the plain bf16 path")

    # The generate CLI on the card: random latents of large f16d32, PNGs.
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        generate.main(["--mode", "random", "--variant", "large", "--num_samples", "4",
                       "--output_dir", tmp])
        files = sorted(os.listdir(tmp))
        if files != ["random.png"] + [f"sample_{i:03d}.png" for i in range(4)]:
            fail(f"generate wrote {files}")
        for f in files:
            with open(os.path.join(tmp, f), "rb") as fh:
                if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                    fail(f"generate: {f} is not a PNG")
        log(f"cli.generate --mode random (large, 4 samples): {files} in "
            f"{time.time() - t:.2f}s")
    torch.cuda.empty_cache()
    return out


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,grad,train,serve,time,eval")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--baseline", metavar="DIR", nargs="+", default=[],
                    help="checkouts whose wgmma kernels (WGMMA_KERNELS) are timed "
                         "beside this tree's (phase kernels)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a CUDA device")
    sys.path.insert(0, ROOT)
    try:
        import deepl_project_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the deepl_project_tpu_torch package is not beside this script ({e})")
    CARD = card_line()
    log(f"card: {CARD}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(CARD, flush=True)

    t0 = time.time()
    phase_build()
    results, baseline = {}, {}
    if "kernels" in phases:
        results.update(phase_kernels())
        results.update(phase_flash_kernels())
        results.update(phase_eval_kernels())
        if args.baseline:
            baseline = phase_baseline(args.baseline)
    if "grad" in phases:
        phase_grad()
    train_counts = {}
    if "train" in phases:
        train_counts, _ = phase_train(args.profile)
    counts = {}
    model = None
    evaluated = {}
    if phases & {"serve", "time", "eval"}:
        from deepl_project_tpu_torch import create_transvae

        model = create_transvae("large", 16, 32, device="cuda", seed=0)
        if "serve" in phases:
            counts = phase_serve(model)
        if "time" in phases:
            phase_time(model, args.profile)
        if "eval" in phases:
            evaluated = phase_eval(model, args.profile)

    if results:
        want = launches_per_reconstruct()[0] if counts else {}
        kernels = []
        for name, source, replaces in (
                ("ln_qkv_rope", "deepl_project_tpu_torch/csrc/ln_qkv_rope.cu",
                 "deepl_project_tpu/ops/pallas/fused_attention_block.py:376"),
                ("attention_core", "deepl_project_tpu_torch/csrc/attention_core.cu",
                 "deepl_project_tpu/ops/pallas/fused_attention_block.py:248"),
                ("proj_bias_gemm", "deepl_project_tpu_torch/csrc/proj_bias_gemm.cu",
                 "deepl_project_tpu/ops/pallas/fused_attention_block.py:248")):
            rows = {k: r for k, r in results.items() if k[0] == name}
            # Times per reconstruct at b32: each shape's time times its launches.
            per = {k: want.get(k, 1) for k in rows}
            tot = lambda key: sum(per[k] * r[key] for k, r in rows.items())  # noqa: E731
            flops = sum(per[k] * r["flops"] for k, r in rows.items())
            nbytes = sum(per[k] * r["bytes"] for k, r in rows.items())
            libs = [r["library_ms"] for r in rows.values()]
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts.get(name, 0),
                "max_abs_err": max(r["err"] for r in rows.values()),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES
                             else "bytes"),
                "library_ms": None if None in libs else tot("library_ms"),
                "per": "one reconstruct at b32 (sum over shapes of launches x time)",
            })
        for name, source, replaces in (
                ("flash_attention_fwd", "deepl_project_tpu_torch/csrc/flash_attention_fwd.cu",
                 "deepl_project_tpu/ops/pallas/flash_attention.py:87"),
                ("flash_attention_bwd", "deepl_project_tpu_torch/csrc/flash_attention_bwd.cu",
                 "deepl_project_tpu/ops/pallas/flash_attention.py:196")):
            r = results[(name, *FLASH_TRAIN)]
            extra = {
                # The serving and sweep shapes: (kernel, SDPA) ms by (B, N, h).
                "ms_by_shape": {str(k[1:]): [v["ms"], v["library_ms"]]
                                for k, v in results.items() if k[0] == name}
            } if name == "flash_attention_fwd" else {
                # One pass for both TPU kernels of _flash_backward: dq (:196)
                # and dk/dv (:218); ms is the whole flash_backward call; the
                # deterministic launcher's call and the memory it adds.
                "also_replaces": "deepl_project_tpu/ops/pallas/flash_attention.py:218",
                "dq_rerun_max_abs_diff": r["rerun_max_abs_diff"],
                "deterministic_ms": r["det_ms"], "deterministic_peak_gib": r["det_peak_gib"]}
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train_counts.get(name, 0),
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": ("operations" if r["flops"] / PEAK_BF16_FLOPS
                             >= r["bytes"] / PEAK_HBM_BYTES else "bytes"),
                "library_ms": r["library_ms"],
                "per": (f"one call at the training microbatch (B, N, h)={FLASH_TRAIN}; "
                        f"launches over {TRAIN_STEPS} training steps"),
                **extra,
            })
        r = results[("small_attention", *SMALL_512)]
        kernels.append({
            "name": "small_attention", "route": "cuda",
            "source": "deepl_project_tpu_torch/csrc/small_attention.cu",
            "replaces": "deepl_project_tpu/ops/pallas/small_attention.py:50",
            "launches": evaluated.get("small_attention_launches", 0),
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "per": (f"one call at 512px stage 4 (B, N, h)={SMALL_512}; launches in the "
                    f"eval phase's 512px sweep ({EVAL_IMAGES} images)"),
        })
        # --baseline: each DIR's and this tree's best times per shape, in turns.
        for row in kernels:
            if row["name"] in baseline:
                row["baseline_turns_ms"] = {
                    d: {str(k): v for k, v in by_shape.items()}
                    for d, by_shape in baseline[row["name"]].items()}
        # group_norm_silu is on no model path (as in the JAX package): its
        # launches in the train, serve and eval phases' runs must be 0.
        norm = {name: (train_counts.get(name, 0) + counts.get(name, 0)
                       + evaluated.get("norm_launches", {}).get(name, 0))
                for name in ("group_norm_stats", "group_norm_apply")}
        if any(norm.values()):
            fail(f"group_norm_silu launched on a model path {norm}: it is documented "
                 f"as on none; update PERF.md and this check")
        whole = [results[("group_norm_silu", *shape)] for shape in GROUP_NORM_SHAPES]
        for name, line, library in (
                ("group_norm_stats", 71, "torch.var_mean over each (image, group)"),
                ("group_norm_apply", 92, "none: no one PyTorch call computes "
                                         "silu(x * mul + add)")):
            rows = [results[(name, *shape)] for shape in GROUP_NORM_SHAPES]
            tot = lambda key: sum(r[key] for r in rows)  # noqa: E731
            row = {
                "name": name, "route": "cuda",
                "source": "deepl_project_tpu_torch/csrc/group_norm_silu.cu",
                "replaces": f"deepl_project_tpu/ops/pallas/fused_norm.py:{line}",
                "launches": norm[name],
                "max_abs_err": max(r["err"] for r in rows), "ms": tot("ms"),
                "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                "bound_by": "bytes",
                "library_ms": None if rows[0]["library_ms"] is None else tot("library_ms"),
                "per": (f"one call at each of {list(GROUP_NORM_SHAPES)} bf16, summed; "
                        f"library: {library}; launches over the train, serve and eval "
                        f"phases' runs"),
            }
            if name == "group_norm_apply":
                # The whole function once: both kernels + the torch epilogue
                # against F.group_norm + F.silu.
                row["group_norm_silu_ms"] = sum(r["ms"] for r in whole)
                row["group_norm_silu_library_ms"] = sum(r["library_ms"] for r in whole)
            kernels.append(row)
        print(json.dumps({"kernels": kernels}), flush=True)
    log(f"all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
