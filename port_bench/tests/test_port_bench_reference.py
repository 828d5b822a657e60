"""The plain float32 reference against the port on a tiny model on the CPU:
the same weights give the same forward and the same training steps, to
float32 rounding (the port's folded FFN and fused resample convs sum in
other orders)."""

from __future__ import annotations

import torch

from port_bench.core import program, spec, weights
from port_bench.reference import model as ref
from port_bench.tests.tiny import tiny_record


def test_forward_matches_the_port():
    rec = tiny_record("large_f16d32.serve_b32")
    cfg = rec.config
    state = weights.model_weights(cfg, 123, torch.device("cpu"))
    port = program.build_model(cfg, "auto", torch.device("cpu"))
    program.load(port, state)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, mu_w, lv_w = ref.forward(cfg, state, x)
        got, mu, lv = port.eval()(x, sample=False)
    assert ref.count(cfg) == sum(p.numel() for p in port.parameters())
    for a, b in ((got, want), (mu, mu_w), (lv, lv_w)):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item()), (
            (a - b).abs().max())


def test_training_steps_match_the_port():
    rec = tiny_record("large_f16d32.train_s1")
    spec.driver("train").run(rec)
    got = {c.name: c.value for c in rec.checks}
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-3 and got["delta_gap"] < 1e-3, got


def test_full_size_parameter_count():
    bench = spec.benchmark()
    cfg = spec.config(bench, "large_f16d32")
    assert ref.count(cfg) == cfg["parameters"] == 1_049_213_827
