"""The window loop gives a step's exact rate at any window length: the step
in flight is finished, none is cut, and nothing is quantised to whole steps
before a deadline."""

from __future__ import annotations

import pytest

from port_bench.core import window


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seconds", [0.5, 1.0, 1.07, 3.3, 10.0, 44.9, 45.0, 51.0])
@pytest.mark.parametrize("step_s", [0.07, 1.07, 2.1])
def test_rate_is_exact_for_a_fixed_step(seconds, step_s):
    clock = FakeClock()
    synced = []

    def step(_):
        clock.now += step_s

    n, elapsed, stamps = window.run(step, seconds, lambda: synced.append(clock.now), clock)
    images = 32
    assert images * n / elapsed == pytest.approx(images / step_s, rel=1e-12)
    assert stamps[-1] >= seconds  # the step in flight was finished
    assert n == 1 or stamps[-2] < seconds  # and no step started after the window
    assert synced == [clock.now]


def test_a_step_that_runs_past_the_window_is_counted_whole():
    clock = FakeClock()
    durations = iter([0.4, 0.4, 5.0])

    def step(_):
        clock.now += next(durations)

    n, elapsed, _ = window.run(step, 1.0, lambda: None, clock)
    assert n == 3 and elapsed == pytest.approx(5.8)
