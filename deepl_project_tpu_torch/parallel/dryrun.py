"""Multi-rank training dry run over gloo (the port's counterpart of the JAX
package's ``dryrun_multichip``):

    python -m deepl_project_tpu_torch.parallel.dryrun [--nproc 4|8] [--device cpu]

Starts ``nproc`` processes (a gloo group through a ``file://`` store in a
temporary directory), each on a CUDA device (rank r on card r mod the card
count; several ranks share a card) unless ``--device cpu`` asks for the
CPU, and runs one training step of the same tiny model, the JAX dry run's
config (three stages, CNN + CNN + transformer at head width 64, fp32, the
scan layout, remat 'dots', two microbatches, L1 + KL), from the same
weights, batch and noise under each strategy:

1. DP x TP: data = nproc / 2, tensor-parallel parameters over model = 2;
2. DP x CP x TP: rows sharded over context = 2 (ring attention, halo
   exchanges, GroupNorm moments over the group), tensor parallelism kept;
3. FSDP over model = 2;
4. the three losses equal within 2e-3 * max(1, |loss|);
5. pipeline x expert parallelism of the latent DiT (the JAX phase's model:
   DiT-S geometry at depth 4, width 64, 4 heads, fp32, 10 classes, no label
   dropout, 2 Switch experts, 2 pipeline microbatches; 8x8x8 latents, b8,
   AdamW 1e-3; its ``pipeline_axis`` holds the blocks stacked, as JAX's):
   one rectified-flow step under a (nproc / 4, 2, 2) mesh of (data, pipe,
   expert), the stack's slices pipelined over pipe and the experts
   split over expert, against the same step on one process (the config's
   sequential fallback), loss within 1e-4 * max(1, |loss|) (the JAX
   phase's bar) and the grad norm within the same bar. The JAX phase's
   weights keep the init's zero adaLN and head, which makes its loss blind
   to the blocks; here those weights are drawn too
   (``models.dit.perturb_zero_init``), so the check reaches the pipeline.
   Run at nproc >= 8 and nproc % 4 == 0, the JAX function's gate.

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
        depths=(1, 1, 1), base_dims=(32, 32, 128), latent_dim=8, head_dim=64, scan_blocks=True,
        remat=True, remat_policy="dots")


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


DIT_TOL = 1e-4


def dit_phase(data: int, pipe: int, expert: int, device: torch.device) -> dict:
    """Phase 5 under a (data, pipe, expert) mesh of every rank: the
    pipelined, expert-parallel step's loss and grad norm and the sequential
    step's (each rank runs the sequential one itself, as the JAX phase runs
    it on one device); raises when they differ."""
    from ..models import create_dit, get_dit_config, perturb_zero_init
    from ..training import TrainState, make_dit_train_step, make_optimizer
    from ..training.train_step import named_trainables
    from .mesh import create_dit_mesh, shard_batch
    from .pipeline import PipelinePlacement

    cfg = get_dit_config("S").replace(
        depth=4, hidden_dim=64, num_heads=4, dtype="float32", param_dtype="float32",
        num_classes=10, class_dropout=0.0, moe_experts=2, pipeline_axis="pipe",
        pipeline_microbatches=2)
    grid, ch, batch = 8, 8, 8
    cfg = cfg.replace(in_channels=ch)
    rng = np.random.default_rng(1)
    z0 = torch.as_tensor(rng.standard_normal((batch, grid, grid, ch)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, 10, batch))

    def step(placement) -> dict:
        # The same weights on every rank: drawn on the CPU, then moved.
        model = perturb_zero_init(create_dit(cfg, grid, device="cpu", seed=0,
                                             placement=placement), 0).to(device)
        named = named_trainables(model)
        opt = make_optimizer(named, learning_rate=1e-3, warmup_steps=0, b2=0.999,
                             weight_decay=1e-4, max_grad_norm=float("inf"),
                             placement=placement)
        mesh = None if placement is None else placement.mesh
        rows = lambda a: torch.as_tensor(shard_batch(mesh, a)).to(device)  # noqa: E731
        m = make_dit_train_step(model, seed=2, placement=placement)(
            TrainState(0, model, opt), rows(z0), rows(labels))
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "keys": sorted(m)}

    ref = step(None)
    got = step(PipelinePlacement(create_dit_mesh(data, pipe, expert)))
    tol = DIT_TOL * max(1.0, abs(ref["loss"]))
    for key in ("loss", "grad_norm"):
        if not (np.isfinite(got[key]) and abs(got[key] - ref[key])
                <= DIT_TOL * max(1.0, abs(ref[key]))):
            raise RuntimeError(f"dry run: PP+EP {key} {got[key]!r} != sequential "
                               f"{ref[key]!r} (tol {tol:.2e})")
    return {"mesh": {"data": data, "pipe": pipe, "expert": expert}, "loss": got["loss"],
            "sequential_loss": ref["loss"], "grad_norm": got["grad_norm"],
            "sequential_grad_norm": ref["grad_norm"], "keys": got["keys"], "tol": tol}


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
    losses = {k: v["total"] for k, v in out.items()}
    if n >= 8 and n % 4 == 0:
        d = dit_phase(n // 4, 2, 2, device)
        losses["PPxEP"] = d["loss"]
        lines.append(f"dryrun PP+EP OK: device={device} mesh={d['mesh']} loss={d['loss']:.6f} "
                     f"(sequential {d['sequential_loss']:.6f}) grad_norm={d['grad_norm']:.6f} "
                     f"(sequential {d['sequential_grad_norm']:.6f}) metrics {d['keys']} "
                     f"(tol {d['tol']:.2e}, t=+{time.perf_counter() - t0:.1f}s)")
    return {"losses": losses, "lines": lines}


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
