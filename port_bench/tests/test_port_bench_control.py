"""The control of each cell, at a tiny size: the port's own int8 path for
the served cells, the float32 reference in fp8 in the program's place for
the training cell. Its readings stand three times or more above the sound
tiny run's on one of the cell's numbers, so a limit set between the two
readings (as the cells' limits are, from their readings at full size on
the card, ``tools/control.py``) fails the control and passes the sound run.
On the CPU, and (marked ``gpu``) on the card."""

from __future__ import annotations

import math

import pytest
import torch

from port_bench.core import spec
from port_bench.tests.tiny import tiny_record

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _readings(workload, device, control):
    rec = tiny_record(workload, control=control)
    rec.device = device
    spec.driver(rec.traffic["driver"]).run(rec)
    return {c.name: c.value for c in rec.checks}


def _separated(workload, device):
    sound, control = _readings(workload, device, False), _readings(workload, device, True)
    apart = [n for n in sound if control[n] >= 3 * max(sound[n], 1e-12)]
    assert apart, (sound, control)
    limits = {n: math.sqrt(max(sound[n], 1e-12) * control[n]) for n in apart}
    rec = tiny_record(workload, control=True)
    rec.device, rec.limits = device, limits
    spec.driver(rec.traffic["driver"]).run(rec)
    assert not rec.correct, (sound, control, limits)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit_between_its_readings(workload):
    _separated(workload, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit_between_its_readings_on_the_card(card, workload):
    _separated(workload, card)
