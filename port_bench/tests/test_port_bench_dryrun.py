"""Every cell's driver dry-run on the CPU at a tiny size: the run ends, its
comparison reads the plain reference's numbers, and no module of JAX or of
the JAX package is loaded (top-level names compared whole)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys, time
sys.path.insert(0, {root!r})
from port_bench.core import env, spec
from port_bench.tests.tiny import tiny_record
bench = spec.benchmark()
out = {{}}
for w in bench["workloads"]:
    rec = tiny_record(w["name"], seed=2**31 + 11, seconds=0.3)
    spec.driver(rec.traffic["driver"]).run(rec)
    out[w["name"]] = {{"e2e": rec.end_to_end, "checks": {{c.name: c.value for c in rec.checks}},
                      "attempted": rec.attempted, "failed": rec.failed}}
print(json.dumps({{"cells": out, "forbidden": env.forbidden_modules(),
                  "loaded": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_every_cell_dry_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "deepl_project_tpu_torch" in got["loaded"]
    assert not {"jax", "jaxlib", "flax", "deepl_project_tpu"} & set(got["loaded"])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(got["cells"]) == {w["name"] for w in bench["workloads"]}
    for name, cell in got["cells"].items():
        assert cell["attempted"] > 0 and cell["failed"] == 0, name
        assert cell["checks"] and all(v is not None for v in cell["checks"].values()), name
        assert cell["e2e"], name
