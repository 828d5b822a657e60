"""Everything a run reads by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic file, its limits file and the readers of
its metrics.

A cell ``<config>.<traffic>`` names ``configs/<config>.json`` (through the
configuration's ``file``), ``traffic/<traffic>.json`` and
``limits/<cell>.json``; a metric ``<name>`` is read by ``metrics/<name>.py``
(its ``read(run)``). Adding a cell, a configuration, a mix or a metric adds
files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # port_bench/
ROOT = HERE.parent  # the checkout


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return {**json.loads((ROOT / c["file"]).read_text()), "name": name}
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return {**json.loads((HERE / "traffic" / f"{name}.json").read_text()), "name": name}


def limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def metrics_for(bench: dict, workload: str, section: str) -> list[dict]:
    """The ``section`` ('end_to_end' or 'per_layer') metrics this cell
    reports: those without a ``workloads`` list, and those that list it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """``metrics/<metric>.py`` as a module (its name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The general driver of a traffic file's ``driver``: ``core/<kind>.py``."""
    return importlib.import_module(f"port_bench.core.{kind}")
