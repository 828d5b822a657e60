#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases, as a check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --profile       # also a torch.profiler breakdown

Phases (any failure exits non-zero and prints no result):

1. build: compile the three Hopper kernels of deepl_project_tpu_torch/csrc
   with nvcc for sm_90a (in parallel) and print ptxas' register and shared
   memory report.
2. kernels: run each kernel at the shapes of large f16d32 @256px, batch 32
   ([B,4096,384] for ln_qkv_rope; [B,1024,768] and [B,256,1536] for all
   three) and hold it against its plain PyTorch version on the same inputs:
   max |kernel - plain| <= 2**-6 * max|plain|, i.e. two bf16 rounding steps
   (ulp <= 2**-7 |v|) at the largest magnitude. Times each kernel, its plain
   version and, where one exists, the one PyTorch call computing the same
   function, with CUDA events.
3. serve: build large f16d32 in bf16 from a seed, serve it over HTTP on
   localhost through InferenceEngine (concurrent uint8/float reconstruct,
   encode and decode requests), with the launch counters set to 0 before and
   read after; check shapes, finiteness and the [0,1] range; check one
   reconstruct launches exactly 20 sublayers and 6 stage-2 ln_qkv_rope
   kernels; hold one reconstruct (b=4) of the kernel path and of the plain
   bf16 path against the same weights in fp32.
4. time: reconstruct images/s at batch 32 through InferenceEngine.run.

The line before the last is the ``kernels`` JSON; the last line is
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

# H100 SXM dense peaks (NVIDIA data sheet) for the bound of each kernel.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_RTOL = 2 ** -6
# Whole-model check: the kernel path and the plain bf16 path round at
# different places in 26 attention sublayers, and a random-weight model
# carries each rounding difference through the decoder, so neither is held to
# the other; both are held to the fp32 computation, and the kernel path must
# be about as close to it as the plain bf16 path.
MODEL_MEAN_RATIO = 1.5
MODEL_MAX_RATIO = 2.0

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
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")


# -- phase 2 -------------------------------------------------------------
def kernel_shapes():
    """(N, C, height, width, batch) of the main path's attention stages."""
    return [(4096, 384, 64, 64, 32), (1024, 768, 32, 32, 32), (256, 1536, 16, 16, 32)]


def launches_per_reconstruct(cfg) -> dict:
    """Expected (kernel, N, C) -> launches in one reconstruct at 256px."""
    from deepl_project_tpu_torch.ops.hopper.fused_attention_block import MAX_SUBLAYER_TOKENS

    out = {}
    for i in range(cfg.num_cnn_stages, cfg.num_stages):
        side = 256 // 2 ** i
        n, c = side * side, cfg.base_dims[i]
        calls = 2 * cfg.depths[i]  # encoder and decoder
        names = (("ln_qkv_rope", "attention_core", "proj_bias_gemm")
                 if n <= MAX_SUBLAYER_TOKENS else ("ln_qkv_rope",))
        for name in names:
            out[(name, n, c)] = calls
    return out


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
            out = fab.proj_bias_gemm(o, wp, bp)
            torch.cuda.synchronize()
            err = check("proj_bias_gemm", n, c, out, fab.proj_bias_reference(o, wp, bp))
            wpb, bpb = wp.to(bf), bp.to(bf)
            rec["proj_bias_gemm"] = {
                "err": err,
                "ms": cuda_time_ms(lambda: fab.proj_bias_gemm(o, wp, bp), 20),
                "plain_ms": cuda_time_ms(lambda: fab.proj_bias_reference(o, wp, bp), 5),
                "library_ms": cuda_time_ms(lambda: F.linear(o, wpb, bpb), 20)}
            # Row 1 as a whole, and its library composition for comparison.
            sub = (x, ln, wq, wk, wv, wp, bp, hh, ww)
            full = fab.fused_attention_sublayer(*sub, packed=packed)
            torch.cuda.synchronize()
            check("fused_attention_sublayer", n, c, full, fab.sublayer_reference(*sub))
            wb = [w.to(bf) for w in (wq, wk, wv)]

            def library_sublayer():
                t = [F.linear(F.layer_norm(x, (c,), g.to(bf), bb.to(bf)), w).reshape(b, n, nh, 64)
                     for (g, bb), w in zip(ln, wb)]
                qh, kh = (apply_rope2d(u, hh, ww) for u in t[:2])
                a = F.scaled_dot_product_attention(
                    *(u.transpose(1, 2) for u in (qh, kh, t[2])))
                return F.linear(a.transpose(1, 2).reshape(b, n, c), wpb, bpb)

            sub_ms = cuda_time_ms(
                lambda: fab.fused_attention_sublayer(*sub, packed=packed), 20)
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


# -- phase 3 -------------------------------------------------------------
def phase_serve(model):
    import urllib.request

    import numpy as np
    import torch

    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
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

    fab.reset_launch_counts()
    t = time.time()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    served_s = time.time() - t
    counts = fab.launch_counts()
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

    # Exactly 20 sublayers + 6 stage-2 qkv kernels per reconstruct.
    fab.reset_launch_counts()
    kern = engine.run("reconstruct", imgs[:4])
    by_shape = fab.launch_counts_by_shape()
    want = launches_per_reconstruct(cfg)
    if by_shape != want:
        fail(f"launches per reconstruct {by_shape} != {want}")
    log(f"one reconstruct launched {by_shape}")

    # Accuracy: the kernel path and the plain bf16 path (every attention
    # sublayer through the plain modules), each against the same weights
    # computed in fp32 on the plain path with TF32 off.
    attn = [m for m in model.modules() if isinstance(m, AttentionRoPE)]
    for m in attn:
        m.impl = "xla"
    fab.reset_launch_counts()
    plain = engine.run("reconstruct", imgs[:4])
    for m in attn:
        m.impl = cfg.attention_impl
    if fab.launch_counts():
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


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,serve,time")
    ap.add_argument("--profile", action="store_true")
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
    results = phase_kernels() if "kernels" in phases else {}
    counts = {}
    if phases & {"serve", "time"}:
        from deepl_project_tpu_torch import create_transvae

        model = create_transvae("large", 16, 32, device="cuda", seed=0)
        if "serve" in phases:
            counts = phase_serve(model)
        if "time" in phases:
            phase_time(model, args.profile)

    if results:
        want = launches_per_reconstruct(model.config) if counts else {}
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
        print(json.dumps({"kernels": kernels}), flush=True)
    log(f"all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
