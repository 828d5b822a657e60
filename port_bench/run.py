#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 port_bench/run.py --workload large_f16d32.serve_b32 --seed 7 \
        --seconds 45 --trace 0

The cell ``<config>.<traffic>`` is looked up in ``BENCHMARK.json``; its
configuration, traffic and limits files and its metrics' readers are found
by name (``core/spec.py``). ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (and ``device.busy_s`` /
``window_s`` and a ``breakdown``). The last line of standard output is the
result as one JSON object; everything else goes to standard error, ending
with each number compared and its limit. The run fails (exit code != 0, no
result) without the CUDA devices the cell asks for, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _metrics(rec, bench, names_section) -> dict:
    from port_bench.core import spec

    out = {}
    for m in spec.metrics_for(bench, rec.workload, names_section):
        name = m["name"]
        if name == "setup_s":
            value = rec.setup_s
        elif names_section == "end_to_end":
            value = rec.end_to_end.get(name)
        else:
            value = spec.reader(name).read(rec)
        if value is not None:
            out[name] = {"value": float(value), "unit": m["unit"]}
    return out


def run(argv=None) -> int:
    args = _args(argv)
    from port_bench.core import env, spec
    from port_bench.core.record import Record
    from port_bench.core.trace import log

    env.prepare()
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    tr = spec.traffic(cell["traffic"])
    rec = Record(workload=args.workload, seed=args.seed, seconds=args.seconds,
                 traced=bool(args.trace), config=cfg, traffic=tr,
                 limits=spec.limits(args.workload), t_start=T0)
    with rec.phase("import"):
        import torch
    env.require_cuda(cell["chips"])
    smi = subprocess.Popen([sys.executable, "-c", "from port_bench.core import env; "
                            "print(env.smi()); print(env.nvcc_version())"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           cwd=str(spec.ROOT))
    with rec.phase("import"):
        import deepl_project_tpu_torch  # noqa: F401
    with rec.phase("cuda_context"):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    try:
        spec.driver(tr["driver"]).run(rec)
    finally:
        log("[device] before the window: " + smi.communicate(timeout=120)[0].strip().replace(
            "\n", "; "))
    log(f"[device] after the window: {env.smi()}")
    bad = env.forbidden_modules()
    if bad:
        log(f"[guard] loaded in this process: {bad}; no result")
        return 3
    section = "per_layer" if rec.traced else "end_to_end"
    result = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": _metrics(rec, bench, section),
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": cell["chips"], "memory_peak_bytes": rec.memory_peak_bytes}}
    if rec.traced and rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in rec.checks}
    log(f"[result] correct {rec.correct}: attempted {rec.attempted}, failed {rec.failed}")
    for c in rec.checks:
        log(f"check {c.name} {c.value} limit {c.limit}")
    return result


def main(argv=None) -> int:
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        result = run(argv)
    if isinstance(result, int):
        return result
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
