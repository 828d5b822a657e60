"""Stress the multi-rank tests' harness (tests/torch_parallel_jobs.py's
RankPool) as the fast test subset under xdist loads it: several pools at
once, each running many short mesh jobs on 4 gloo ranks (create_mesh at
data x model = 4 x 1, 2 x 2, 1 x 4, as tests/test_torch_parallel_trainer.py's
test_create_mesh_coordinates_match_jax does). A pool stops at its first
fault and reports it with the outcome of the job after it.

    python scripts/stress_rank_pool.py [--tests DIR] [--pools 8] [--jobs 300]

``--tests``: the tests directory whose harness runs (another checkout's, to
compare two harnesses on one machine). A job's timeout is 30 s (a mesh job
takes well under a second). Prints one JSON line a pool and a summary;
exits 1 if any pool saw a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((4, 1), (2, 2), (1, 4))


def _one(pool, jobs, tmp, i: int) -> tuple[str, str]:
    import numpy as np

    data, model = MESHES[i % len(MESHES)]
    label = f"[{data}-{model}]"
    try:
        got = pool.run(jobs.mesh_coordinates, 4, tmp, data, model)
    except Exception as e:  # noqa: BLE001 -- the fault is what this run reports
        return type(e).__name__, f"{label} " + " | ".join(str(e).splitlines()[-3:])[:600]
    want = {r: tuple(int(x) for x in np.unravel_index(r, (data, 1, model))) for r in range(4)}
    wrong = [(r, c) for r, c in got if c != want[r]]
    return ("ok", label) if not wrong else ("wrong", f"{label} coordinates {wrong}")


def _pool(tests: str, n: int) -> None:
    sys.path.insert(0, tests)
    import torch_parallel_jobs as jobs

    jobs.JOB_TIMEOUT_S = 30
    pool = jobs.RankPool(4)
    counts: dict = {}
    out = {"jobs": 0}
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n):
            kind, text = _one(pool, jobs, tmp, i)
            counts[kind] = counts.get(kind, 0) + 1
            out["jobs"] += 1
            if kind != "ok":
                out["fault"] = {"job": i, "kind": kind, "text": text}
                out["next"] = dict(zip(("kind", "text"), _one(pool, jobs, tmp, i + 1)))
                break
    out.update(counts=counts, s=round(time.time() - t0, 1))
    print(json.dumps(out), flush=True)
    for p in pool.procs:  # a stuck rank would hold a clean exit
        p.kill()
    os._exit(0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tests", default=os.path.join(ROOT, "tests"))
    ap.add_argument("--pools", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=300)
    ap.add_argument("--pool", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    tests = os.path.abspath(args.tests)
    if args.pool:
        _pool(tests, args.jobs)
        return
    env = {**os.environ, "PYTHONPATH": os.path.dirname(tests)}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--pool", "--tests",
                               tests, "--jobs", str(args.jobs)], stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True, env=env)
             for _ in range(args.pools)]
    rows = []
    for p in procs:
        out, _ = p.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        rows.append(json.loads(lines[-1]) if lines else {"jobs": 0, "error": f"exit {p.returncode}"})
        print(json.dumps(rows[-1]), flush=True)
    faults = [r for r in rows if "fault" in r or "error" in r]
    print(f"{tests}: {args.pools} pools, {sum(r['jobs'] for r in rows)} jobs, "
          f"{len(faults)} faults", flush=True)
    sys.exit(1 if faults else 0)


if __name__ == "__main__":
    main()
