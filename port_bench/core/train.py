"""Training traffic: ``Trainer.step_fn(state, batch)``, stage 1.

Set-up builds one ``Trainer`` and its state (the port's model, AdamW, the
stage-1 loss with LPIPS), copies the benchmark's weights into the model and
its LPIPS weights into the trainer's, draws a pool of image batches from
the seed on the device, and drives that same state through
``check_steps`` optimizer steps on distinct batches: they warm every shape
(AdamW's moments exist and the allocator has reached its peak) and are what
the reference follows. The window then calls the step on the pool's
batches in turn until ``--seconds`` have passed, finishing the step in
flight (``core.window``); the rate is all images of all its steps over the
time to the device sync after the last. Nothing else runs in the window: no
host-to-device copy, no logging, no checkpoint.

A ``--trace 1`` run measures ``trace_seconds`` of steps without the
profiler (their rate feeds ``mfu.train``), then as long with it and a
``kernel.*`` range around each hand-written kernel launch; then
``sync_steps`` steps with ``torch.cuda.set_sync_debug_mode('warn')``
counting every device-to-host sync, and as many with the optimizer's step
timed on the host clock, synced at both ends.

After the window the trainer and its state are freed, and the float32
reference repeats the first ``check_steps`` steps from the same weights,
images and latent noise, in blocks of ``ref_block`` images.
"""

from __future__ import annotations

import gc
import statistics
import time
import warnings

import torch

from ..reference import model as ref
from ..reference import train as ref_train
from . import device, inputs, program, weights, window
from .spec import ROOT
from .trace import Trace, log

_B1, _B2, _EPS = 0.9, 0.95, 1e-8  # the port's make_optimizer defaults


def _noise_generator(seed: int, step: int, device) -> torch.Generator:
    """The latent noise of optimizer step ``step`` as the port draws it
    (``training.train_step.step_generator``: seed * 1_000_003 + step); the
    reference draws the same numbers from it."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def _leaf_norms(tensors) -> list[float]:
    """The L2 norm of each tensor (a 0-d tensor is taken as a norm already),
    one at a time, so that no more than one leaf's temporaries live."""
    return torch.stack([t if t.dim() == 0 else t.norm() for t in tensors]).double().cpu().tolist()


def run(rec) -> None:
    if rec.control:
        # The control: the reference at the next precision down (fp8) in
        # the program's place, held to the float32 reference.
        names = [n for n, _, _ in ref.param_spec(rec.config)]
        rec.window_starts()
        prog = _reference(rec, names, "fp8", host=True)
        device.free(torch.device(rec.device))
        _compare(rec, names, prog)
        return
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg, tr, seed = rec.config, rec.traffic, rec.seed
    dev = torch.device(rec.device)
    res, batch, npool, nsteps = tr["resolution"], tr["batch"], tr["pool"], tr["check_steps"]
    with rec.phase("trainer"):
        tc = TrainerConfig(batch_size=batch, accum_steps=tr["accum_steps"],
                           learning_rate=tr["learning_rate"], warmup_steps=tr["warmup_steps"],
                           max_grad_norm=tr["max_grad_norm"],
                           weights=LossWeights(**tr["loss_weights"]), use_lpips=True,
                           resolution=res, seed=seed, output_dir=str(ROOT / ".bench_cache"))
        trainer = Trainer(program.model_config(cfg, cfg["attention_impl"]["train"]), tc,
                          device=dev)
        state = trainer.create_state()
    with rec.phase("weights"):
        w = weights.model_weights(cfg, seed, dev)
        program.load(state.model, w)
        names = state.optimizer.names
        p0 = {k: w[k].to("cpu") for k in names}
        del w
        lp = weights.lpips_weights(seed, dev)
        with torch.no_grad():
            for group, leaves in trainer.lpips_params.items():
                for k, t in leaves.items():
                    t.copy_(lp[group][k])
        del lp
    with rec.phase("kernel_build"):
        if dev.type == "cuda":
            program.build_kernels()
    with rec.phase("inputs"):
        pool = inputs.images(seed, npool * batch, res, dev).view(npool, batch, res, res, 3)
    step = trainer.step_fn
    with rec.phase("warmup"):
        metrics = []
        for i in range(nsteps):
            metrics.append(step(state, pool[i % npool]))
            if i == 0:
                g1 = [n / (1.0 - _B1) for n in _leaf_norms(state.optimizer.mu)]
                g1_host = [m.to("cpu", copy=True) for m in state.optimizer.mu]  # its direction
        losses = [{k: float(m[k]) for k in ("total", "l1", "lpips", "kl")} for m in metrics]
        delta = _leaf_norms((p - p0[k].to(dev)).norm()
                            for k, p in zip(names, state.optimizer.params))
        del p0
        device.sync(dev)
    rec.counters["launches_setup"] = program.launch_counts()
    program.reset_launch_counts()
    rec.memory_peak_bytes = device.peak_bytes(dev)
    device.reset_peak(dev)
    retries = device.alloc_retries(dev)
    rec.window_starts()
    log(f"[window] start: num_alloc_retries {retries}")

    done = [nsteps]

    def one(_):
        step(state, pool[done[0] % npool])
        done[0] += 1

    seconds = rec.seconds if not rec.traced else tr["trace_seconds"]
    n, elapsed, stamps = window.run(one, seconds, lambda: device.sync(dev))
    rate = n * batch / elapsed
    if not rec.traced:
        rec.end_to_end["train_img_per_s"] = rate
    else:
        rec.counters["untraced_rate"] = rate
        trace = Trace()
        with program.kernel_log(True) as klog:
            trace.start()
            klog.active = True
            n2, elapsed2, _ = window.run(one, seconds, lambda: device.sync(dev))
            klog.active = False
            trace.stop()
        rec.trace, rec.kernels = trace, klog
        rec.counters["traced_rate"] = n2 * batch / elapsed2
        rec.counters["window_peak_bytes"] = device.peak_bytes(dev)
        _counted_steps(rec, state, step, pool, done, tr["sync_steps"])
    device.sync(dev)
    rec.counters.setdefault("window_peak_bytes", device.peak_bytes(dev))
    rec.memory_peak_bytes = max(rec.memory_peak_bytes, device.peak_bytes(dev))
    retries = device.alloc_retries(dev)
    log(f"[window] end: num_alloc_retries {retries}; {n} optimizer steps, {n * batch} images "
        f"in {elapsed:.3f} s; launches by path {program.launch_counts()}")
    log("[window] step stamps (s from the start, host clock; diagnostic only): "
        + " ".join(f"{t:.3f}" for t in stamps))
    rec.attempted = n
    rec.failed = state.optimizer.total_notfinite
    del trainer, state, step, metrics, pool
    gc.collect()
    device.free(dev)
    _compare(rec, names, {"losses": losses, "g1": g1, "g1_host": g1_host, "delta": delta})


def _counted_steps(rec, state, step, pool, done, count) -> None:
    """``count`` steps counting device-to-host syncs, then ``count`` with the
    optimizer's step timed (synced at both ends)."""
    caught, dev = [], torch.device(rec.device)
    device.sync(dev)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(count):
                step(state, pool[done[0] % len(pool)])
                done[0] += 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    rec.counters["host_syncs"] = len(syncs) / count
    log(f"[syncs] {len(syncs)} in {count} steps at: " + "; ".join(
        sorted({f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in syncs})))
    opt, times = state.optimizer, []
    inner = opt.step

    def timed(grads):
        device.sync(dev)
        t = time.perf_counter()
        out = inner(grads)
        device.sync(dev)
        times.append(time.perf_counter() - t)
        return out

    opt.step = timed
    try:
        for _ in range(count):
            step(state, pool[done[0] % len(pool)])
            done[0] += 1
    finally:
        del opt.step
    rec.counters["optim_ms"] = [t * 1e3 for t in times]


def _cos_gaps(host: list, want: list) -> list[float]:
    """1 - cos of each leaf's first gradient (the program's, on the host)
    against the reference's, in float64; 1 where the program's is zero."""
    out = []
    for a, b in zip(host, want):
        a, b = a.to(b.device, torch.float64).flatten(), b.double().flatten()
        den = a.norm() * b.norm()
        out.append(float(1.0 - a.dot(b) / den) if float(den) > 0 else 1.0)
    return out


def _reference(rec, names, precision: str = "fp32", host: bool = False,
               against: list | None = None) -> dict:
    """The first ``check_steps`` steps of the reference from the seed's
    weights, images and latent noise: each step's loss terms, the first
    gradient's leaf norms before the clip (``raw``) and as AdamW got it
    (``g1``; with ``host`` the leaves too, on the host), each leaf's 1 - cos
    against the leaves ``against`` (``cos_gap``), and each leaf's change over
    the steps (``delta``)."""
    cfg, tr, seed = rec.config, rec.traffic, rec.seed
    dev = torch.device(rec.device)
    ref.strict_fp32()
    t = time.perf_counter()
    made = weights.model_weights(cfg, seed, dev)
    params = {k: made[k].clone().requires_grad_() for k in names}
    del made
    p0 = {k: v.detach().clone() for k, v in params.items()}
    lp = weights.lpips_weights(seed, dev)
    batch, accum = tr["batch"], tr["accum_steps"]
    micro = batch // accum
    f = 2 ** (len(cfg["depths"]) - 1)
    lat = (micro, cfg["latent_dim"], tr["resolution"] // f, tr["resolution"] // f)
    pool = inputs.images(seed, tr["pool"] * batch, tr["resolution"], dev)
    opt = ref_train.AdamW(params, tr["learning_rate"], _B1, _B2, _EPS, 0.0, tr["max_grad_norm"],
                          tr["warmup_steps"])
    out = {"losses": []}
    for s in range(tr["check_steps"]):
        gen = _noise_generator(seed, s, dev)
        eps = [torch.randn(lat, generator=gen, device=dev) for _ in range(accum)]
        rows = slice((s % tr["pool"]) * batch, (s % tr["pool"] + 1) * batch)
        grads, terms = ref_train.gradients(cfg, params, lp, pool[rows], eps,
                                           tr["loss_weights"], micro, tr["ref_block"],
                                           ref.Ops(precision))
        if s == 0:
            out["raw"] = _leaf_norms(grads[k] for k in names)
        clipped = opt.step(grads)
        if s == 0:
            out["g1"] = _leaf_norms(clipped[k] for k in names)
            if host is not None:
                out["g1_host"] = [clipped[k].to("cpu", copy=True) for k in names]
            if against is not None:
                out["cos_gap"] = _cos_gaps(against, [clipped[k] for k in names])
        del grads, clipped
        out["losses"].append(terms)
    out["delta"] = _leaf_norms((params[k].detach() - p0[k]).norm() for k in names)
    log(f"[check] reference ({precision}): {tr['check_steps']} steps in "
        f"{time.perf_counter() - t:.1f} s")
    return out


def _compare(rec, names, prog: dict) -> None:
    """The first steps (``prog``: the program's losses, first gradient as
    the optimizer got it, by leaf norm and on the host, and change per leaf)
    against the float32 reference's: the worst step's loss gap, the worst
    leaf's gap in gradient norm and in direction (1 - cos), the worst
    leaf's gap in change. Leaves whose reference gradient is under a thousandth of
    the median leaf's (rounding alone moves them under Adam) are left out
    of the two leaf numbers."""
    want = _reference(rec, names, against=prog.pop("g1_host"))
    for s, (a, b) in enumerate(zip(prog["losses"], want["losses"])):
        log(f"[check] step {s + 1} loss: program {a} reference {b}")
    raw = want["raw"]
    floor = 1e-3 * statistics.median(raw)
    kept = [i for i, r in enumerate(raw) if r >= floor]
    log(f"[check] {len(names) - len(kept)} of {len(names)} leaves left out (reference "
        f"gradient under {floor:.3e}): {[names[i] for i in range(len(names)) if i not in kept]}")
    rec.check("loss_gap", max(abs(a["total"] - b["total"]) / abs(b["total"])
                              for a, b in zip(prog["losses"], want["losses"])))
    rec.check("grad_gap", _worst_leaf(prog["g1"], want["g1"], kept, names, "grad"))
    cos = want["cos_gap"]
    worst = max(kept, key=lambda i: cos[i])
    log(f"[check] grad direction: worst leaf {names[worst]} 1 - cos {cos[worst]:.3e}; median "
        f"leaf {statistics.median(cos[i] for i in kept):.3e}")
    rec.check("grad_cos_gap", cos[worst])
    rec.check("delta_gap", _worst_leaf(prog["delta"], want["delta"], kept, names, "delta"))


def _worst_leaf(prog, want, kept, names, what) -> float:
    """max over kept leaves of |norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want[i] for i in kept)
    gaps = [(abs(prog[i] - want[i]) / max(want[i], med), i) for i in kept]
    gap, i = max(gaps)
    log(f"[check] {what}: worst leaf {names[i]} program {prog[i]:.6e} reference "
        f"{want[i]:.6e} (median leaf {med:.6e}); median gap {statistics.median(g for g, _ in gaps):.3e}")
    return gap
