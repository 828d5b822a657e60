#!/usr/bin/env python3
"""Run cells of the benchmark one after another, one process a run, and
summarise them: each run's result line, the numbers compared, and per cell
and metric the median and the spread (the distance between the first and
third quartiles of ``statistics.quantiles(values, n=4)``, over the median).

    python3 port_bench/tools/series.py --out chiprun_out/series \
        --run large_f16d32.serve_b32:101:0:45 --run large_f16d32.serve_b32:102:0:45

Each ``--run`` is ``workload:seed:trace:seconds``; ``--sets N`` repeats the
whole list N times (the same seeds in each set). Each run's standard output
and error are kept in ``--out``; the summary is printed and written to
``<out>/summary.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parents[1] / "run.py"


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--run", action="append", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--timeout", type=float, default=1300)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for s in range(args.sets):
        for spec in args.run:
            workload, seed, trace, seconds = spec.split(":")
            tag = f"set{s}_{workload}_{seed}_t{trace}"
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, str(RUN), "--workload", workload, "--seed",
                                   seed, "--seconds", seconds, "--trace", trace],
                                  capture_output=True, text=True, timeout=args.timeout)
            wall = time.perf_counter() - t
            (out / f"{tag}.out").write_text(proc.stdout)
            (out / f"{tag}.err").write_text(proc.stderr)
            line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
            try:
                result = json.loads(line)
            except json.JSONDecodeError:
                result = None
            rows.append({"set": s, "workload": workload, "seed": int(seed), "trace": int(trace),
                         "rc": proc.returncode, "wall_s": wall, "result": result})
            brief = ({k: v["value"] for k, v in result["metrics"].items()} if result else
                     proc.stderr[-1500:])
            print(f"[{tag}] rc {proc.returncode} wall {wall:.1f} s correct "
                  f"{result and result['correct']}: {brief} checks "
                  f"{result and {k: v['value'] for k, v in result['checks'].items()}}",
                  flush=True)
    summary = {}
    for r in rows:
        if not r["result"] or r["trace"]:
            continue
        for name, m in r["result"]["metrics"].items():
            summary.setdefault(r["workload"], {}).setdefault(name, {}).setdefault(
                r["set"], []).append(m["value"])
    report = {}
    for w, metrics in summary.items():
        for name, sets in metrics.items():
            report[f"{w} {name}"] = {
                str(s): {"median": statistics.median(v), "spread": spread(v), "n": len(v)}
                for s, v in sets.items()}
            print(f"{w} {name}: " + "; ".join(
                f"set {s} median {x['median']:.6g} spread {x['spread']} n {x['n']}"
                for s, x in report[f'{w} {name}'].items()))
    (out / "summary.json").write_text(json.dumps({"runs": rows, "spreads": report}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
