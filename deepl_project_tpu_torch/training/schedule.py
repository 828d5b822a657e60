"""Learning-rate schedules (PyTorch port of ``training/schedule.py``): plain
functions of the 0-based update count, with optax's formulas."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule: init -> end over ``steps``, then held."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def warmup_constant(base_lr: float = 1e-4, warmup_steps: int = 10_000) -> Schedule:
    """Linear warmup from 0, then constant (the reference recipe)."""
    if warmup_steps <= 0:
        return lambda count: base_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, base_lr, warmup_steps, count)
        return base_lr

    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_lr_ratio: float = 0.0) -> Schedule:
    """Linear warmup from 0, then cosine decay to base_lr * final_lr_ratio
    at ``total_steps`` (optax.warmup_cosine_decay_schedule)."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    end = base_lr * final_lr_ratio
    alpha = 0.0 if base_lr == 0.0 else end / base_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, base_lr, warmup_steps, count)
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule
