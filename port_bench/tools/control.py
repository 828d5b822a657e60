#!/usr/bin/env python3
"""Read the control of a cell: what its comparison gives when the program
is replaced by the next precision down, which the limits must fail; or,
with ``--fault``, what it gives with a fault planted under the timed path
(``core/faults.py``).

    python3 port_bench/tools/control.py --workload large_f16d32.serve_b32 \
        --seeds 11,12,13 --seconds 6 [--fault half_batch]

Served cells run the port's own int8 path (``quantize_model``, scope 'all')
through the same engine, traffic and sampled comparison; the training cell
runs the float32 reference's first steps in fp8 in the program's place.
Each seed runs in its own process (``--one``); the numbers compared are
printed per seed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def one(workload: str, seed: int, seconds: float, fault: str | None) -> dict:
    import contextlib

    from port_bench.core import env, faults, spec
    from port_bench.core.record import Record

    env.prepare()
    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    rec = Record(workload=workload, seed=seed, seconds=seconds, traced=False,
                 config=spec.config(bench, cell["config"]), traffic=spec.traffic(cell["traffic"]),
                 limits=spec.limits(workload), t_start=time.perf_counter(),
                 control=fault is None)
    if fault is not None:
        faults.plant(fault, rec.traffic["driver"])
    with contextlib.redirect_stdout(sys.stderr):
        env.require_cuda(cell["chips"])
        spec.driver(rec.traffic["driver"]).run(rec)
    return {c.name: {"value": c.value, "limit": c.limit, "fails": not c.ok} for c in rec.checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--fault", default=None, help="plant this fault instead (core/faults.py)")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.workload, int(args.seeds), args.seconds, args.fault)),
              flush=True)
        return 0
    for seed in args.seeds.split(","):
        extra = [] if args.fault is None else ["--fault", args.fault]
        proc = subprocess.run([sys.executable, __file__, "--one", "--workload", args.workload,
                               "--seeds", seed, "--seconds", str(args.seconds), *extra],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-3000:])
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "no result"
        what = "control" if args.fault is None else f"fault {args.fault}"
        print(f"[{what}] {args.workload} seed {seed} rc {proc.returncode}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
