"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, traffic mix and metric found by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from port_bench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_run_seconds_fit_a_full_check(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    cells = {w["name"] for w in bench["workloads"]}
    assert 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        e2e = [m["name"] for m in spec.metrics_for(bench, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_for(bench, w["name"], "per_layer")
        assert layer
        for m in layer:  # each moves an end-to-end metric the cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_every_entry_is_found_by_name(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        tr = spec.traffic(w["traffic"])
        assert spec.driver(tr["driver"]).run
        assert spec.limits(w["name"]), f"limits/{w['name']}.json"
        assert cfg["depths"] and tr["driver"] in ("serve", "train")
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_a_new_entry_needs_no_edit(tmp_path, monkeypatch, bench):
    """A cell, configuration, traffic mix and metric added as files and
    entries are found, with no existing file changed."""
    root = tmp_path / "checkout"
    here = root / "port_bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "large_f16d32.json").read_text())
    (here / "configs" / "huge_f16d32.json").write_text(json.dumps(
        {**cfg, "variant": "huge_f16d32", "depths": [3, 3, 4, 6, 8],
         "base_dims": [256, 256, 512, 1024, 2048]}))
    tr = json.loads((here / "traffic" / "serve_b32.json").read_text())
    (here / "traffic" / "serve_c4b8.json").write_text(json.dumps({**tr, "clients": 4,
                                                                   "batch": 8}))
    (here / "limits" / "huge_f16d32.serve_c4b8.json").write_text('{"rms_levels": 1.0}')
    (here / "metrics" / "queue_ms.serve.py").write_text(
        "def read(rec):\n    return rec.counters.get('queue_ms')\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "huge_f16d32", "source": "x", "file":
                           "port_bench/configs/huge_f16d32.json", "reduced": [], "why": "x"})
    new["workloads"].append({"name": "huge_f16d32.serve_c4b8", "config": "huge_f16d32",
                             "traffic": "serve_c4b8", "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "queue_ms.serve", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "serving engine",
                             "moves": "serve_img_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", root)
    b = spec.benchmark()
    cell = spec.cell(b, "huge_f16d32.serve_c4b8")
    assert spec.config(b, cell["config"])["base_dims"][-1] == 2048
    assert spec.traffic(cell["traffic"])["clients"] == 4
    assert spec.limits(cell["name"]) == {"rms_levels": 1.0}
    layer = [m["name"] for m in spec.metrics_for(b, cell["name"], "per_layer")]
    assert "queue_ms.serve" in layer
    assert spec.reader("queue_ms.serve").read(type("R", (), {"counters": {"queue_ms": 2.5}})) == 2.5
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run fails and prints no result (the program is not there;
    without a card it fails before that)."""
    import subprocess
    import sys

    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "large_f16d32.serve_b32", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
