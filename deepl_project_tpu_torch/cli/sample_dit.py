"""DiT sampling CLI (PyTorch port of ``cli/sample_dit.py``): a ``cli.train_dit``
checkpoint -> class-conditional images.

Restores the DiT from its checkpoint and ``dit_config.json`` sidecar (the
EMA parameters where the checkpoint has them, unless --no-use_ema), the
TransVAE tokenizer (the sidecar's ``vae_checkpoint`` unless
--vae_checkpoint overrides it; random weights from seed 0 without either),
runs the CFG Euler rectified-flow sampler and writes ``grid.png`` plus one
PNG per sample. An unconditional checkpoint samples the null class at CFG 1.

Usage:
  python -m deepl_project_tpu_torch.cli.sample_dit --checkpoint runs/dit \\
      --num_samples 16 --cfg_scale 4.0 --classes 207,250,387

The JAX CLI's flags, with ``--device`` (default cuda; 'cpu' runs the plain
PyTorch path) in the place of its ``--platform``.
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sample images from a trained DiT "
                                            "(PyTorch, CUDA)")
    p.add_argument("--checkpoint", required=True,
                   help="train_dit output dir (checkpoint + dit_config.json)")
    p.add_argument("--vae_checkpoint", default=None,
                   help="override the tokenizer checkpoint recorded at "
                        "training time")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--classes", default=None,
                   help="comma-separated class ids; default cycles 0..N")
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction,
                   default=True, help="sample from EMA params when present")
    p.add_argument("--output_dir", default="samples")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..models import DiTConfig, create_dit
    from ..models.transvae import resolve_device
    from ..training import LatentStats, generate_images
    from ..training.checkpoint import restore_checkpoint
    from ..utils.convert import load_state_dict
    from ..utils.image import save_grid, save_image
    from .train_dit import load_tokenizer

    device = resolve_device(args.device)
    with open(os.path.join(args.checkpoint, "dit_config.json")) as f:
        side = json.load(f)
    dcfg = DiTConfig(**side["dit"])
    dit = create_dit(dcfg, side["grid"], device=device, seed=None)

    raw, meta = restore_checkpoint(args.checkpoint, map_location=device)
    inner = raw["state"]
    # Either block layout loads into the sidecar config's (utils.convert).
    if args.use_ema and inner.get("ema"):
        load_state_dict(dit, inner["ema"])
        src = "ema"
    else:
        load_state_dict(dit, inner["model"])
        src = "live"
    dit.eval()
    stats = LatentStats(mean=raw["latent_mean"], std=raw["latent_std"])

    vae_ckpt = args.vae_checkpoint or side.get("vae_checkpoint")
    if not vae_ckpt:
        print("WARNING: no tokenizer checkpoint recorded; random decoder")
    vae = load_tokenizer(vae_ckpt, side["vae_variant"], side["vae_compression"], device)

    cfg_scale = args.cfg_scale
    if side.get("unconditional"):
        # Trained with class_dropout 1 (no real labels): the null token is the
        # only trained embedding, and CFG > 1 would extrapolate between two
        # unconditional branches.
        print("NOTE: unconditional checkpoint -- ignoring --classes, forcing cfg_scale=1.0")
        labels = [dcfg.num_classes] * args.num_samples
        cfg_scale = 1.0
    elif args.classes:
        ids = [int(c) for c in args.classes.split(",")]
        labels = [ids[i % len(ids)] for i in range(args.num_samples)]
    else:
        labels = [i % dcfg.num_classes for i in range(args.num_samples)]
    labels = torch.tensor(labels, dtype=torch.long, device=device)

    print(f"sampling {args.num_samples} images (step {meta['step']}, {src} "
          f"params, cfg {cfg_scale}, {args.sample_steps} steps)")
    imgs = generate_images(vae, None, dit, None, stats,
                           torch.Generator(device=device).manual_seed(args.seed), labels,
                           grid=side["grid"], num_steps=args.sample_steps,
                           cfg_scale=cfg_scale).cpu().numpy()
    os.makedirs(args.output_dir, exist_ok=True)
    save_grid(imgs, os.path.join(args.output_dir, "grid.png"))
    for i, img in enumerate(imgs):
        save_image(img, os.path.join(args.output_dir,
                                     f"sample_{i:03d}_c{int(labels[i])}.png"))
    print(f"wrote {len(imgs)} images to {args.output_dir}")
    return imgs


if __name__ == "__main__":
    main()
