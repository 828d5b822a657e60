"""What one run gathers: the set-up split, the end-to-end numbers, the
counters and stamps the per-layer readers read, the trace, and the
comparisons that decide ``correct``."""

from __future__ import annotations

import contextlib
import dataclasses
import time

from .trace import log


@dataclasses.dataclass
class Check:
    name: str
    value: float | None
    limit: float | None

    @property
    def ok(self) -> bool:
        return self.value is not None and self.limit is not None and self.value <= self.limit


@dataclasses.dataclass
class Record:
    workload: str
    seed: int
    seconds: float
    traced: bool
    config: dict
    traffic: dict
    limits: dict
    t_start: float  # process clock at the start of the run
    device: str = "cuda"  # the CPU only in the tests' dry runs
    control: bool = False  # run the control in the program's place (tools/control.py)
    setup: dict = dataclasses.field(default_factory=dict)
    setup_s: float | None = None
    end_to_end: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    trace: object = None  # core.trace.Trace of the traced window
    kernels: object = None  # core.program.KernelLog of the traced window
    attempted: int = 0
    failed: int = 0
    checks: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        yield
        self.setup[name] = self.setup.get(name, 0.0) + time.perf_counter() - t

    def window_starts(self) -> None:
        """Set-up ends here: from the process's start to the window's."""
        self.setup_s = time.perf_counter() - self.t_start
        log(f"[setup] {self.setup_s:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.setup.items()))

    def check(self, name: str, value: float | None) -> None:
        self.checks.append(Check(name, value, self.limits.get(name)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0
