"""A run with its timed path broken underneath comes out not correct under
the cell's own limits, once for each fault the cell can have: a served
answer altered where it is produced; half of a served batch left out; a
training step that leaves its state unchanged; a training step on half of
its batch, the mean taken over the rest. The unbroken tiny run comes out
correct under the same limits. One card: no exchange between chips to
leave out. Runs on the CPU at a tiny size, past the harness's look for a
card."""

from __future__ import annotations

import pytest

from port_bench.core import faults, spec
from port_bench.tests.tiny import tiny_record

CELLS = {w["name"]: spec.traffic(w["traffic"])["driver"] for w in spec.benchmark()["workloads"]}
SERVE = [w for w, d in CELLS.items() if d == "serve"]
TRAIN = [w for w, d in CELLS.items() if d == "train"]


@pytest.fixture
def plant():
    undo = []
    yield lambda kind, driver: undo.append(faults.plant(kind, driver))
    for u in undo:
        u()


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_unbroken_tiny_run_is_correct(workload):
    rec = tiny_record(workload)
    spec.driver(rec.traffic["driver"]).run(rec)
    assert rec.correct, [(c.name, c.value, c.limit) for c in rec.checks]


@pytest.mark.parametrize("kind", faults.SERVE)
@pytest.mark.parametrize("workload", SERVE)
def test_served_fault_is_not_correct(plant, workload, kind):
    plant(kind, "serve")
    rec = tiny_record(workload)
    spec.driver("serve").run(rec)
    assert not rec.correct, [(c.name, c.value, c.limit) for c in rec.checks]


@pytest.mark.parametrize("kind", faults.TRAIN)
@pytest.mark.parametrize("workload", TRAIN)
def test_training_fault_is_not_correct(plant, workload, kind):
    plant(kind, "train")
    rec = tiny_record(workload)
    spec.driver("train").run(rec)
    assert not rec.correct, [(c.name, c.value, c.limit) for c in rec.checks]
