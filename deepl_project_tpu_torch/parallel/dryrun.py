"""Multi-rank training dry run over gloo (the port's counterpart of the JAX
package's ``dryrun_multichip``):

    python -m deepl_project_tpu_torch.parallel.dryrun [--nproc 4] [--device cpu]

Starts ``nproc`` processes (a gloo group through a ``file://`` store in a
temporary directory), each on a CUDA device (rank r on card r mod the card
count; several ranks share a card) unless ``--device cpu`` asks for the
CPU, and runs one training step of the same tiny model
(three stages, CNN + CNN + transformer at head width 64, fp32, remat
'dots', two microbatches, L1 + KL) from the same weights, batch and noise
under each strategy:

1. DP x TP: data = nproc / 2, tensor-parallel parameters over model = 2;
2. DP x CP x TP: rows sharded over context = 2 (ring attention, halo
   exchanges, GroupNorm moments over the group), tensor parallelism kept;
3. FSDP over model = 2;
4. the three losses equal within 2e-3 * max(1, |loss|).

With fewer than 4 ranks (or an odd count) the model and context axes are 1
and phase 2 is skipped, as in the JAX function. On CUDA the convolutions
run without TF32, so that the strategies are compared in fp32. Exits
non-zero on any failure.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models.transvae import resolve_device

RES = 32
TOL = 2e-3


def _config():
    from ..config import get_config

    return get_config("tiny_f16d32", dtype="float32", attention_impl="xla").replace(
        depths=(1, 1, 1), base_dims=(32, 32, 128), latent_dim=8, head_dim=64, remat=True,
        remat_policy="dots")


def _step(x_host: np.ndarray, data: int, context: int, model: int, mode: str,
          device: torch.device) -> dict:
    """One optimizer step of the dry run's model on ``device`` under a
    (data, context, model) mesh and parameter ``mode``: loss and grad
    norm."""
    from ..losses import LossWeights
    from ..models import TransVAE, init_weights
    from ..training.optim import make_optimizer
    from ..training.train_step import TrainState, make_train_step, named_trainables
    from .context import shard_rows
    from .mesh import create_mesh
    from .sharding import shard_params

    mesh = create_mesh(data=data, context=context, model=model)
    cfg = _config()
    if context > 1:
        cfg = cfg.replace(context_axis="context")
    with torch.device("meta"):
        net = TransVAE(cfg)
    # The same weights on every device: drawn on the CPU, then moved.
    net = init_weights(net.to_empty(device="cpu"), torch.Generator().manual_seed(0)).to(device)
    placement = shard_params(mesh, net, mode, fsdp_min_size=2 ** 10)
    opt = make_optimizer(named_trainables(net), learning_rate=1e-3, warmup_steps=0,
                         placement=placement)
    state = TrainState(0, net, opt)
    step = make_train_step(LossWeights(lpips=0.0, kl=1e-6, vf=0.0, gan=0.0), accum_steps=2,
                           seed=3, placement=placement)
    metrics = step(state, torch.as_tensor(shard_rows(mesh, x_host, accum_steps=2)).to(device))
    total = float(metrics["total"])
    if not np.isfinite(total) or state.step != 1:
        raise RuntimeError(f"dry run under {mode} {data}x{context}x{model}: loss {total}, "
                           f"step {state.step}")
    return {"total": total, "grad_norm": float(metrics["grad_norm"]),
            "mesh": {"data": data, "context": context, "model": model}}


def run(device=None) -> dict:
    """The dry run's phases on the ranks of the default process group, on
    ``device`` (default CUDA: card rank mod the card count; raises without
    CUDA); every rank returns the same losses."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    n = dist.get_world_size()
    model = 2 if n % 2 == 0 and n >= 4 else 1
    context = 2 if n % (model * 2) == 0 and n >= 4 else 1
    batch = n // model * 2
    x_host = np.random.default_rng(0).random((batch, RES, RES, 3)).astype(np.float32)
    t0 = time.perf_counter()
    out, lines = {}, []

    def done(name, row):
        out[name] = row
        lines.append(f"dryrun {name} OK: device={device} mesh={row['mesh']} "
                     f"loss={row['total']:.6f} "
                     f"grad_norm={row['grad_norm']:.6f} (t=+{time.perf_counter() - t0:.1f}s)")

    done("DPxTP", _step(x_host, n // model, 1, model, "tensor", device))
    if context > 1:
        done("DPxCPxTP", _step(x_host, n // (model * context), context, model, "tensor",
                               device))
    done("FSDP", _step(x_host, n // model, 1, model, "fsdp", device))
    ref = out["DPxTP"]["total"]
    tol = TOL * max(1.0, abs(ref))
    for name, row in out.items():
        if abs(row["total"] - ref) > tol:
            raise RuntimeError(f"dry run: {name} loss {row['total']!r} != DPxTP loss {ref!r} "
                               f"(tol {tol:.2e})")
    lines.append(f"dryrun equality OK: {', '.join(f'{k}={v['total']:.6f}' for k, v in out.items())}"
                 f" (tol {tol:.2e})")
    return {"losses": {k: v["total"] for k, v in out.items()}, "lines": lines}


def _rank(rank: int, world: int, store: str, device: str, results) -> None:
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = run(device)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, args.nproc, os.path.join(tmp, "store"),
                                                 args.device, results))
                 for r in range(args.nproc)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    if any(p.exitcode != 0 for p in procs):
        print(f"dryrun FAILED: rank exit codes {[p.exitcode for p in procs]}", file=sys.stderr)
        return 1
    for line in results.get(timeout=10)["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
