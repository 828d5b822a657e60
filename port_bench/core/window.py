"""The measured window of a stepped workload.

The loop runs whole steps until ``seconds`` have passed since its start and
finishes the step in flight; the rate is all the work of all those steps
over the time from the start to the device sync after the last one. So no
step is cut and none is left out: the rate is the steps' own, at any window
length, with no quantisation to whole steps before a deadline.
"""

from __future__ import annotations

import time


def run(step, seconds: float, sync=lambda: None, clock=time.perf_counter):
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed,
    then ``sync()``. Returns (steps, elapsed seconds, per-step host stamps
    relative to the start)."""
    t0 = clock()
    stamps = []
    n = 0
    while True:
        step(n)
        n += 1
        stamps.append(clock() - t0)
        if stamps[-1] >= seconds:
            break
    sync()
    return n, clock() - t0, stamps
