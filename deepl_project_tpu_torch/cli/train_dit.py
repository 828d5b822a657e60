"""Latent-DiT training CLI (PyTorch port of ``cli/train_dit.py``): the paper's
Table 2(b) pipeline, a DiT trained by rectified flow on the latents of a
frozen TransVAE tokenizer, on one CUDA device.

Usage (smoke, random tokenizer):
  python -m deepl_project_tpu_torch.cli.train_dit --dit_variant B --vae_variant tiny \\
      --data synthetic --resolution 64 --batch_size 8 --total_steps 20 \\
      --output_dir out/dit

With a trained tokenizer (a checkpoint directory of ``cli.train``):
  python -m deepl_project_tpu_torch.cli.train_dit --vae_checkpoint out/vae/checkpoints \\
      --data /data/imagenet --resolution 256 --total_steps 400000

The JAX CLI's flags and defaults, and ``--device`` (default cuda; 'cpu' runs
the plain PyTorch path). The tokenizer encodes each batch under no_grad in
its compute dtype (bf16), which is the path of the Hopper kernels on the
card. A checkpoint holds {'state': {'model', 'optimizer', 'step'[, 'ema']},
'latent_mean', 'latent_std'} (``training/checkpoint.py``), beside a
``dit_config.json`` sidecar from which ``cli.sample_dit`` (or the JAX
package, ``DiTConfig(**side['dit'])``) rebuilds the model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a latent DiT on TransVAE "
                                            "latents (rectified flow; PyTorch, CUDA)")
    # DiT
    p.add_argument("--dit_variant", default="B", choices=["S", "B", "L", "XL"])
    p.add_argument("--patch_size", type=int, default=2)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--class_dropout", type=float, default=0.1)
    p.add_argument("--plain_dit", action="store_true",
                   help="disable the LightningDiT modernizations "
                        "(RMSNorm/SwiGLU/RoPE)")
    # Tokenizer
    p.add_argument("--vae_variant", default="tiny",
                   choices=["tiny", "base", "large", "huge", "giant"])
    p.add_argument("--vae_compression", type=int, default=16, choices=[8, 16])
    p.add_argument("--vae_checkpoint", default=None,
                   help="checkpoint dir of a trained TransVAE; random "
                        "init when omitted (smoke only)")
    # Data
    p.add_argument("--data", default="synthetic")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--stats_batches", type=int, default=8,
                   help="batches used to estimate latent channel stats")
    # Training
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--total_steps", type=int, default=400_000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--time_sampling", default="logit_normal",
                   choices=["logit_normal", "uniform"])
    p.add_argument("--ema_decay", type=float, default=0.9999,
                   help="EMA of DiT params for eval/sampling; 0 disables")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --output_dir")
    p.add_argument("--seed", type=int, default=42)
    # Sampling / logging
    p.add_argument("--sample_every", type=int, default=0,
                   help="if > 0, write a sample grid every N steps")
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--save_every", type=int, default=10_000)
    p.add_argument("--fid_every", type=int, default=0,
                   help="if > 0, compute generation FID every N steps "
                        "(InceptionV3 when converted weights exist, else "
                        "VGG features -- relative-only) and append it to "
                        "<output_dir>/history.jsonl")
    p.add_argument("--fid_samples", type=int, default=256,
                   help="samples per FID evaluation (paper FID-10K uses "
                        "10000; shapes-scale trajectories use fewer)")
    p.add_argument("--output_dir", default="outputs/dit")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def load_tokenizer(checkpoint: str | None, variant: str, compression: int, device,
                   seed: int = 0):
    """The frozen TransVAE in eval mode. Its architecture comes from the
    checkpoint's ``config.json`` where one exists: rebuilt from the variant
    flags alone, a ``norm_latents=True`` checkpoint would fail to load its
    norm (the JAX CLI's reason is silent random-scale latents). Without a
    checkpoint the weights are random, drawn from ``seed`` (smoke only)."""
    from ..config import get_config
    from ..models.transvae import TransVAE, init_weights
    from ..training.checkpoint import load_config, restore_model_params

    cfg = None
    if checkpoint:
        try:
            cfg = load_config(checkpoint)
        except (FileNotFoundError, OSError):
            cfg = None
    if cfg is None:
        cfg = get_config(variant, compression)
    with torch.device("meta"):
        vae = TransVAE(cfg)
    vae = vae.to_empty(device=device)
    if checkpoint:
        vae.load_state_dict(restore_model_params(checkpoint, map_location=device), strict=True)
    else:
        print("WARNING: no tokenizer checkpoint; random tokenizer (smoke only)")
        init_weights(vae, torch.Generator(device=device).manual_seed(seed))
    return vae.eval().requires_grad_(False)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data import batch_iterator, make_dataset
    from ..models import create_dit, get_dit_config
    from ..models.transvae import resolve_device
    from ..training import (LatentStats, TrainState, encode_to_latents, make_dit_train_step,
                            make_optimizer, save_checkpoint)
    from ..training.checkpoint import latest_step, restore_checkpoint
    from ..training.train_step import init_ema
    from ..utils.convert import load_state_dict, resume_in_model_layout
    from ..utils.logging import RunHistory

    device = resolve_device(args.device)
    vae = load_tokenizer(args.vae_checkpoint, args.vae_variant, args.vae_compression, device,
                         args.seed)
    vcfg = vae.config

    def encode(images_np) -> torch.Tensor:
        return encode_to_latents(vae, None, images_np).float()

    # Labeled batches (images [B, H, W, 3], labels [B]); sources without
    # class structure label -1. Without real labels the model trains
    # unconditional: class_dropout 1 routes every sample to the null token,
    # and sampling forces cfg_scale 1.
    def epoch_batches():
        # Finite sources exhaust; diffusion training counts steps, so loop.
        while True:
            yield from batch_iterator(
                make_dataset(args.data, args.resolution, with_labels=True), args.batch_size)

    raw_batches = epoch_batches()
    first_batch = next(raw_batches)
    has_labels = bool((first_batch[1] >= 0).any())
    class_dropout = args.class_dropout if has_labels else 1.0
    if not has_labels:
        print("NOTE: dataset provides no class labels -- training "
              "unconditional (class_dropout=1.0, sampling cfg_scale=1.0)")

    def batches(first, rest):
        yield first
        yield from rest

    data = batches(first_batch, raw_batches)

    grid = args.resolution // vcfg.compression_ratio
    dcfg = get_dit_config(args.dit_variant, args.patch_size, in_channels=vcfg.latent_dim,
                          num_classes=args.num_classes, class_dropout=class_dropout)
    if args.plain_dit:
        dcfg = dcfg.replace(use_rmsnorm=False, use_swiglu=False, use_rope=False)
    # The sidecar from which cli.sample_dit rebuilds the model; on --resume
    # an existing one is kept (the resuming flags may omit facts it records).
    os.makedirs(args.output_dir, exist_ok=True)
    sidecar = os.path.join(args.output_dir, "dit_config.json")
    if not (args.resume and os.path.exists(sidecar)):
        with open(sidecar, "w") as f:
            json.dump({"dit": dataclasses.asdict(dcfg), "vae_variant": args.vae_variant,
                       "vae_compression": args.vae_compression,
                       "vae_checkpoint": args.vae_checkpoint,
                       "resolution": args.resolution, "grid": grid,
                       "unconditional": not has_labels}, f, indent=2)
    dit = create_dit(dcfg, grid, device=device, seed=args.seed + 1).train()
    n_params = sum(p.numel() for p in dit.parameters())
    print(f"DiT-{args.dit_variant}/{args.patch_size}: {n_params / 1e6:.1f}M "
          f"params on {grid}x{grid}x{vcfg.latent_dim} latents")

    # Latent channel statistics from the first batches.
    lat0 = [encode(next(data)[0]) for _ in range(args.stats_batches)]
    stats = LatentStats.from_latents(torch.cat(lat0))
    del lat0
    print(f"latent stats: mean|max|={stats.mean.abs().max().item():.3f} "
          f"std range [{stats.std.min().item():.3f}, {stats.std.max().item():.3f}]")

    use_ema = args.ema_decay > 0.0
    state = TrainState(step=0, model=dit,
                       optimizer=make_optimizer(list(dit.named_parameters()),
                                                learning_rate=args.lr,
                                                warmup_steps=args.warmup_steps, b2=0.95),
                       ema=init_ema(dit) if use_ema else None)
    step_fn = make_dit_train_step(dit, args.time_sampling,
                                  args.ema_decay if use_ema else None, seed=args.seed)

    start_step = 0
    if args.resume and latest_step(args.output_dir) is not None:
        raw, meta = restore_checkpoint(args.output_dir, map_location=device)
        inner = raw["state"]
        # A checkpoint of either block layout (the stacked one of a
        # scan_blocks / pipeline_axis config, or the unrolled one).
        load_state_dict(dit, inner["model"])
        saved_opt, saved_ema = resume_in_model_layout(dit, inner["optimizer"], inner.get("ema"))
        state.optimizer.load_state_dict(saved_opt)  # AdamW: converts in either layout
        if use_ema:
            state.ema = dict(saved_ema)
        state.step = int(inner["step"])
        stats = LatentStats(mean=raw["latent_mean"], std=raw["latent_std"])
        start_step = int(meta["step"])
        print(f"resumed from step {start_step} in {args.output_dir}")

    def ckpt_payload() -> dict:
        inner = {"model": dit.state_dict(), "optimizer": state.optimizer.state_dict(),
                 "step": state.step}
        if use_ema:
            inner["ema"] = state.ema
        return {"state": inner, "latent_mean": stats.mean, "latent_std": stats.std}

    history = RunHistory(os.path.join(args.output_dir, "history.jsonl"))

    fid_feature_fn, fid_key, fid_real = None, None, None
    if args.fid_every:
        from ..evaluation import make_fid_feature_fn

        fid_feature_fn, fid_key = make_fid_feature_fn(device)
        fid_key = fid_key.replace("rfid", "gen_fid")
        # One real pool for every evaluation, from a SEPARATE iterator: a
        # resumed run scores against the same pool, and training sees the
        # same batches.
        fid_pool_iter = batch_iterator(
            make_dataset(args.data, args.resolution, with_labels=True), args.batch_size)
        fid_real, seen = [], 0
        while seen < args.fid_samples:
            b = next(fid_pool_iter)[0]
            fid_real.append(b)
            seen += b.shape[0]

    best_fid = [float("inf")]
    # A resumed run must not overwrite a better earlier best checkpoint.
    best_meta = os.path.join(args.output_dir, "best", "metrics.json")
    if args.resume and os.path.exists(best_meta):
        with open(best_meta) as f:
            best_fid[0] = json.load(f).get(fid_key or "gen_fid", float("inf"))

    def run_fid(step: int) -> float:
        from ..training.diffusion import generation_fid

        fid = generation_fid(
            vae, None, dit, state.ema if use_ema else None, stats, iter(fid_real),
            fid_feature_fn, torch.Generator(device=device).manual_seed(step),
            num_samples=args.fid_samples, batch_size=args.batch_size, grid=grid,
            num_steps=args.sample_steps, cfg_scale=args.cfg_scale if has_labels else 1.0,
            unconditional=not has_labels)
        print(f"step {step}: {fid_key} {fid:.3f} ({args.fid_samples} samples)")
        history.append(step, {fid_key: fid}, kind="fid")
        # Best-FID retention: the newest checkpoints lose the best sampler
        # when training ends off its FID minimum.
        if fid < best_fid[0]:
            best_fid[0] = fid
            best_dir = os.path.join(args.output_dir, "best")
            save_checkpoint(best_dir, step, ckpt_payload(), max_to_keep=1,
                            metrics={fid_key: fid})
            print(f"step {step}: new best {fid_key} {fid:.3f} -> {best_dir}")
        return fid

    t0, imgs_seen = time.time(), 0
    for i in range(start_step, args.total_steps):
        images_np, labels_np = next(data)
        # Unlabeled samples (-1) take the trained null class at index
        # num_classes, the token the CFG dropout uses.
        labels = torch.from_numpy(np.where(labels_np < 0, args.num_classes,
                                           labels_np)).long().to(device)
        z0 = stats.normalize(encode(images_np))
        metrics = step_fn(state, z0, labels)
        imgs_seen += images_np.shape[0]
        if (i + 1) % args.log_every == 0:
            dt = time.time() - t0
            host = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                    "images_per_sec": imgs_seen / dt}
            print(f"step {i + 1}: loss {host['loss']:.4f} grad_norm {host['grad_norm']:.3f} "
                  f"{host['images_per_sec']:.1f} img/s")
            history.append(i + 1, host, kind="train")
            t0, imgs_seen = time.time(), 0
        if args.fid_every and (i + 1) % args.fid_every == 0:
            run_fid(i + 1)
        if args.save_every and (i + 1) % args.save_every == 0:
            save_checkpoint(args.output_dir, i + 1, ckpt_payload())
        if args.sample_every and (i + 1) % args.sample_every == 0:
            write_samples(args, vae, dit, state.ema if use_ema else None, stats, grid, i + 1,
                          has_labels=has_labels)

    if start_step < args.total_steps:
        save_checkpoint(args.output_dir, args.total_steps, ckpt_payload())
    print(f"done; checkpoint at {args.output_dir}")


def write_samples(args, vae, dit, dit_params, stats, grid: int, step: int,
                  has_labels: bool = True) -> str:
    """A grid of 8 samples (classes 0..7 with CFG; the null class at CFG 1
    for an unconditional model) at ``<output_dir>/samples_<step>.png``."""
    from ..training import generate_images
    from ..utils.image import save_grid

    device = next(dit.parameters()).device
    if has_labels:
        labels = torch.arange(8, device=device) % args.num_classes
        cfg_scale = args.cfg_scale
    else:
        labels = torch.full((8,), args.num_classes, dtype=torch.long, device=device)
        cfg_scale = 1.0
    imgs = generate_images(vae, None, dit, dit_params, stats,
                           torch.Generator(device=device).manual_seed(step), labels,
                           grid=grid, num_steps=args.sample_steps, cfg_scale=cfg_scale)
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, f"samples_{step:07d}.png")
    save_grid(imgs.cpu().numpy(), path, nrow=4)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
