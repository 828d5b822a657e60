"""The device trace of a ``--trace 1`` run and what is read from it.

``Trace`` runs ``torch.profiler`` (CPU and CUDA activities) over the traced
window and reduces the raw events to: the device's busy time (the union of
kernel, copy and set intervals inside the window), the device time by
kernel name, the longest idle gaps named by the host operation that was
running when each began, and the device time of the hand-written kernels'
launches (``kernel.*`` ranges that ``core.kernels`` opens around each
launch). Times are the profiler's nanosecond clock, the host's wall clock.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
import time

import torch

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_KINDS = ("cpu_op", "user_annotation", "python_function")
_RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")


def _kind(e, host_names: set) -> str:
    """The activity's kind. Where the profiler's events do not carry one
    (older PyTorch), from the device and the name: a device event named as
    a host range is the range's device-side annotation; a host event named
    like a CUDA API call is a runtime call."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if getattr(e, "is_user_annotation", lambda: False)() or name in host_names:
            return "gpu_user_annotation"
        return "gpu_memcpy" if name.startswith(("Memcpy", "Memset")) else "kernel"
    return "cuda_runtime" if re.match(r"^cu(da)?[A-Z]", name) else "cpu_op"


class Trace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0
        self.device = []  # (start_ns, end_ns, name, correlation ids)
        self.host = []  # (start_ns, end_ns, name, thread)
        self.runtime = []  # (start_ns, end_ns, thread, correlation ids)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        host_names = {e.name() for e in events
                      if e.device_type() != torch.autograd.DeviceType.CUDA}
        for e in events:
            kind = _kind(e, host_names)
            s = e.start_ns()
            end = s + e.duration_ns()
            ids = {e.correlation_id(), e.linked_correlation_id()} - {0}
            if kind in _DEVICE_KINDS:
                self.device.append((s, end, e.name(), ids))
            elif kind in _RUNTIME_KINDS:
                self.runtime.append((s, end, e.start_thread_id(), ids))
            elif kind in _HOST_KINDS:
                self.host.append((s, end, e.name(), e.start_thread_id()))
        self.prof = None

    # -- reductions ---------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        spans = sorted((max(s, self.t0), min(e, self.t1)) for s, e, _, _ in self.device
                       if e > self.t0 and s < self.t1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for s, e, name, _ in self.device:
            by[_short(name)] += (e - s) / 1e9
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        busy = self.busy_intervals()
        edges = [self.t0] + [x for se in busy for x in se] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        host = sorted(self.host)
        out = []
        for length, at in gaps:
            name = "none"
            for s, e, n, _ in host:
                if s > at:
                    break
                if e >= at:
                    name = n  # the latest-starting op still running: innermost
            out.append([f"host:{_short(name)}", length / 1e9])
        return out

    def range_device_s(self, prefix: str) -> dict[str, float]:
        """Device seconds of the kernels launched inside each host range
        whose name starts with ``prefix``, by range name: a runtime call
        inside the range links its device work by correlation id."""
        ranges = [(s, e, n, t) for s, e, n, t in self.host if n.startswith(prefix)]
        if not ranges:
            return {}
        ranges.sort()
        starts = [r[0] for r in ranges]
        owner: dict[int, str] = {}
        for s, e, tid, ids in self.runtime:
            i = bisect.bisect_right(starts, s) - 1
            while i >= 0:
                rs, re_, name, rt = ranges[i]
                if rt == tid and rs <= s and e <= re_:
                    for c in ids:
                        owner[c] = name
                    break
                if starts[i] < s - 10**9:
                    break
                i -= 1
        out = collections.Counter()
        for s, e, _, ids in self.device:
            for c in ids:
                if c in owner:
                    out[owner[c]] += (e - s) / 1e9
                    break
        return dict(out)

    def named_device_s(self, pattern: re.Pattern) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        return sum((e - s) for s, e, n, _ in self.device if pattern.search(n)) / 1e9


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]+", "_", name)[:64]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
