"""A cell of ``BENCHMARK.json`` cut to a tiny size for the CPU tests: the
same traffic file, driver and comparison, a micro model in float32."""

from __future__ import annotations

import time

from port_bench.core import spec
from port_bench.core.record import Record

TINY_MODEL = {"depths": [1, 1, 1, 1], "base_dims": [32, 32, 64, 128], "latent_dim": 4,
              "head_dim": 32, "dtype": "float32", "flops_key": ["large", 16, 32]}


def tiny_record(workload: str, seed: int = 5, seconds: float = 0.3, control: bool = False,
                dtype: str = "float32") -> Record:
    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    cfg = {**spec.config(bench, cell["config"]), **TINY_MODEL, "dtype": dtype}
    tr = dict(spec.traffic(cell["traffic"]))
    tr.update(resolution=32, pool=3, ref_block=2, trace_seconds=0.3)
    if tr["driver"] == "serve":
        tr.update(batch=4, max_batch=4)
    else:
        tr.update(batch=4, accum_steps=2, check_steps=2, sync_steps=1)
    return Record(workload=workload, seed=seed, seconds=seconds, traced=False, config=cfg,
                  traffic=tr, limits=spec.limits(workload), t_start=time.perf_counter(),
                  device="cpu", control=control)
