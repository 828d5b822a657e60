"""Served traffic: closed-loop clients of ``InferenceEngine.submit``.

Set-up draws the weights and a pool of request batches (uint8 images) from
the seed on the device, builds the port's model and engine, builds its
kernels and warms the one request shape the traffic sends. In the window
``clients`` threads each send a request, wait for its reply and send the
next, until ``--seconds`` have passed; requests in flight are finished. The
rate is all images returned over the time from the window's start to the
last reply; the latency of a request runs from its submit to its reply.

A ``--trace 1`` run measures a window of ``trace_seconds`` without the
profiler (its rate feeds ``mfu.serve``), then one with it, with CUDA events
around the engine's group computation and the model's encoder and decoder,
and a ``kernel.*`` range around each hand-written kernel launch.

After the window the engine and the model are freed, and the sampled
requests' images (``check_requests`` of them, drawn from the seed among each
client's first ``check_span`` replies) are reconstructed by the float32
reference on the same weights and compared, in uint8 levels.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from ..reference import model as ref
from . import device, inputs, program, weights
from .trace import Trace, log


class _Timed:
    """CUDA events around each call of ``fn`` on the current stream; the
    images of each call are counted from its first argument."""

    def __init__(self, fn, images=lambda *a, **k: a[0].shape[0]):
        self.fn, self.images, self.calls, self.on = fn, images, [], False

    def __call__(self, *a, **k):
        if not self.on:
            return self.fn(*a, **k)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*a, **k)
        end.record()
        self.calls.append((start, end, self.images(*a, **k)))
        return out

    def ms(self) -> list[tuple[float, int]]:
        return [(s.elapsed_time(e), n) for s, e, n in self.calls]


def _request_index(client: int, k: int, offset: int, pool: int) -> int:
    return (offset + client * 7 + k * 3) % pool


def _clients(engine, pool, tr, seconds, offset, keep):
    """Run the closed-loop clients for ``seconds``; returns (t0, stamps,
    kept, errors): each request's (submit, reply) host times, the (pool
    index, reply) of the requests (client, ordinal) in ``keep``, and the
    failures."""
    op, out_dtype, n = tr["op"], tr["out_dtype"], tr["clients"]
    stamps, kept, errors = [[] for _ in range(n)], {}, []
    go = threading.Barrier(n + 1)
    box = {}

    def client(c):
        go.wait()
        t0, k = box["t0"], 0
        while True:  # at least one request each; none starts after the window
            idx = _request_index(c, k, offset, len(pool))
            sub = time.perf_counter()
            try:
                out = engine.submit(op, pool[idx], out_dtype)
                if out.shape != pool[idx].shape:
                    raise ValueError(f"reply of shape {out.shape} to {pool[idx].shape}")
            except Exception as e:  # noqa: BLE001 -- counted as failed
                errors.append(f"{type(e).__name__}: {e}")
                out = None
            stamps[c].append((sub, time.perf_counter()))
            if (c, k) in keep:
                kept[(c, k)] = (idx, None if out is None else np.array(out))
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    box["t0"] = time.perf_counter()
    go.wait()
    for t in threads:
        t.join()
    return box["t0"], stamps, kept, errors


def _summary(t0, stamps, batch):
    lat = [d - s for per in stamps for s, d in per]
    end = max(d for per in stamps for _, d in per)
    return {"requests": len(lat), "images": len(lat) * batch, "elapsed": end - t0,
            "rate": len(lat) * batch / (end - t0), "latencies": lat}


def run(rec) -> None:
    from deepl_project_tpu_torch.serving import InferenceEngine

    cfg, tr, seed = rec.config, rec.traffic, rec.seed
    dev = torch.device(rec.device)
    res, batch, npool = tr["resolution"], tr["batch"], tr["pool"]
    with rec.phase("weights"):
        state = weights.model_weights(cfg, seed, dev)
    with rec.phase("model"):
        model = program.build_model(cfg, cfg["attention_impl"]["serve"], dev)
        program.load(model, state)
        del state
        model.eval()
    if rec.control:
        # The control: the program's own int8 path (post-training
        # quantization of every ResBlock and ConvFFN, calibrated on two
        # batches of the pool) in the place of the bf16 model.
        from deepl_project_tpu_torch.quantize import quantize_model

        calib = inputs.images(seed, 8, res, dev).cpu().numpy()
        model = quantize_model(model, [calib[:4], calib[4:]], scope="all")
    with rec.phase("kernel_build"):
        if dev.type == "cuda":
            program.build_kernels()
    with rec.phase("inputs"):
        pool = inputs.uint8(inputs.images(seed, npool * batch, res, dev))
        pool = pool.view(npool, batch, res, res, 3).cpu().numpy()
    rng = np.random.default_rng(seed)
    offset = int(rng.integers(npool))
    # Each client's first check_span replies are kept; the sample is drawn
    # from them after the window.
    span = {(c, k) for c in range(tr["clients"]) for k in range(tr["check_span"])}
    engine = InferenceEngine(model, max_batch=tr["max_batch"],
                             batch_window_ms=tr["batch_window_ms"])
    with rec.phase("warmup"):
        for _ in range(tr["warmup_groups"]):
            engine.run(tr["op"], pool[0], tr["out_dtype"])
        engine.start()
        _clients(engine, pool, tr, 0.0, offset, set())
        device.sync(dev)
    rec.counters["launches_setup"] = program.launch_counts()
    program.reset_launch_counts()
    rec.memory_peak_bytes = device.peak_bytes(dev)
    device.reset_peak(dev)
    retries = device.alloc_retries(dev)
    rec.window_starts()
    log(f"[window] start: num_alloc_retries {retries}")

    if not rec.traced:
        t0, stamps, kept, errors = _clients(engine, pool, tr, rec.seconds, offset, span)
        s = _summary(t0, stamps, batch)
        rec.end_to_end["serve_img_per_s"] = s["rate"]
        lat = np.percentile(s["latencies"], [50, 95]) * 1e3
        log(f"[window] request latency: median {lat[0]:.3f} ms, p95 {lat[1]:.3f} ms "
            f"({s['requests']} requests)")
    else:
        s0 = _summary(*_clients(engine, pool, tr, tr["trace_seconds"], offset, set())[:2],
                      batch)
        rec.counters["untraced_rate"] = s0["rate"]
        group, enc, dec = (_Timed(engine._compute, lambda op, x, dt: x.shape[0]),
                           _Timed(model.encode), _Timed(model.decode))
        engine._compute, model.encode, model.decode = group, enc, dec
        trace = Trace()
        with program.kernel_log(True) as klog:
            for t in (group, enc, dec):
                t.on = True
            trace.start()
            klog.active = True
            t0, stamps, kept, errors = _clients(engine, pool, tr, tr["trace_seconds"], offset,
                                                span)
            klog.active = False
            trace.stop()
            for t in (group, enc, dec):
                t.on = False
        s = _summary(t0, stamps, batch)
        rec.trace, rec.kernels = trace, klog
        rec.counters.update(group_ms=group.ms(), encode_ms=enc.ms(), decode_ms=dec.ms(),
                            traced_rate=s["rate"], latencies=s["latencies"])
    device.sync(dev)
    rec.counters["window_peak_bytes"] = device.peak_bytes(dev)
    rec.memory_peak_bytes = max(rec.memory_peak_bytes, rec.counters["window_peak_bytes"])
    retries = device.alloc_retries(dev)
    log(f"[window] end: num_alloc_retries {retries}; {s['requests']} requests, "
        f"{s['images']} images in {s['elapsed']:.3f} s; launches by path "
        f"{program.launch_counts()}")
    rec.attempted, rec.failed = s["requests"], len(errors)
    for e in errors[:5]:
        log(f"[window] request failed: {e}")
    engine.stop()
    del engine, model
    gc.collect()
    device.free(dev)
    keys = sorted(kept)
    pick = rng.choice(len(keys), size=min(tr["check_requests"], len(keys)), replace=False)
    _compare(rec, pool, {keys[i]: kept[keys[i]] for i in sorted(pick)})


def _compare(rec, pool, kept) -> None:
    """The sampled replies against the float32 reference on the same
    weights: the RMS difference in uint8 levels over every pixel of every
    sampled image (an image's RMS is logged too). A sampled request that
    failed has no reply; it is counted among the failed requests."""
    cfg, tr = rec.config, rec.traffic
    ref.strict_fp32()
    dev = torch.device(rec.device)
    t = time.perf_counter()
    params = weights.model_weights(cfg, rec.seed, dev)
    per_image = []
    by_index: dict[int, list] = {}
    for _, (idx, out) in sorted(kept.items()):
        if out is not None:
            by_index.setdefault(idx, []).append(out)
    for idx, outs in sorted(by_index.items()):
        x = torch.from_numpy(pool[idx]).to(dev)
        want = ref.reconstruct(cfg, params, x, tr["ref_block"]) * 255.0
        for out in outs:
            diff = torch.from_numpy(out).to(dev).float() - want
            per_image += diff.square().mean(dim=(1, 2, 3)).tolist()
    rms = float(np.sqrt(np.mean(per_image))) if per_image else None
    log(f"[check] {len(per_image)} images of {len(kept)} requests against the reference in "
        f"{time.perf_counter() - t:.1f} s; per-image RMS levels: median "
        f"{np.sqrt(np.median(per_image)) if per_image else None}, worst "
        f"{np.sqrt(max(per_image)) if per_image else None}")
    rec.check("rms_levels", rms)
