"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).
Each returns None where the run has nothing to read."""

from __future__ import annotations

import statistics

from ..work import flops as fwork
from ..work import kernels as kwork
from .trace import log


def roofline(rec) -> float | None:
    """The hand-written kernels' bound time over their device time, in %,
    over every launch of the traced window. The device time is that of the
    kernels each ``kernel.*`` range launched (by correlation); where the
    trace links none to a range, that of the kernels by name."""
    if rec.trace is None or rec.kernels is None or not rec.kernels.bound_s:
        return None
    bound = sum(rec.kernels.bound_s.values())
    by_range = rec.trace.range_device_s("kernel.")
    device, how = sum(by_range.values()), "ranges"
    if device <= 0:
        device, how = rec.trace.named_device_s(kwork.KERNEL_NAMES), "kernel names"
    log(f"[roofline] bound {bound:.6f} s over device {device:.6f} s (by {how}); calls "
        f"{rec.kernels.calls}; device by range {by_range}")
    return 100.0 * bound / device if device > 0 else None


def idle_share(rec) -> float | None:
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def peak_gib(rec) -> float | None:
    peak = rec.counters.get("window_peak_bytes")
    return None if peak is None else peak / 2**30


def _flops_key(rec):
    fam, f, d = rec.config["flops_key"]
    return fam, f, d, rec.traffic["resolution"]


def mfu_serve(rec) -> float | None:
    rate = rec.counters.get("untraced_rate")
    if rate is None:
        return None
    return 100.0 * rate * fwork.forward_flops(*_flops_key(rec)) / fwork.PEAK_BF16


def mfu_train(rec) -> float | None:
    rate = rec.counters.get("untraced_rate")
    if rate is None:
        return None
    return 100.0 * rate * fwork.train_flops(*_flops_key(rec)) / fwork.PEAK_BF16


def device_ms_per_image(rec, key: str) -> float | None:
    calls = rec.counters.get(key)
    if not calls:
        return None
    return sum(ms for ms, _ in calls) / sum(n for _, n in calls)


def engine_overhead_ms(rec) -> float | None:
    lat, groups = rec.counters.get("latencies"), rec.counters.get("group_ms")
    if not lat or not groups:
        return None
    return statistics.median(lat) * 1e3 - statistics.median(ms for ms, _ in groups)


def median_of(rec, key: str) -> float | None:
    values = rec.counters.get(key)
    return statistics.median(values) if values else None
