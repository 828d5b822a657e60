"""Generation CLI (PyTorch port of ``cli/generate.py``): random,
interpolate and reconstruct modes, PNGs written to ``--output_dir``.

Usage:
  python -m deepl_project_tpu_torch.cli.generate --mode random --checkpoint ckpt/
  python -m deepl_project_tpu_torch.cli.generate --mode reconstruct --image a.png
  python -m deepl_project_tpu_torch.cli.generate --mode interpolate --image a.png \
      --image_b b.png --steps 8

Without ``--checkpoint`` the model of ``--variant`` gets random weights from
seed 0, with a warning. ``--device cpu`` runs the plain PyTorch path. The
interpolate and reconstruct modes read image files, which needs PIL; the PNGs
are written without it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate images with TransVAE (PyTorch)")
    p.add_argument("--mode", default="random",
                   choices=["random", "interpolate", "reconstruct"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--variant", default="tiny")
    p.add_argument("--compression_ratio", type=int, default=16)
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--latent_hw", type=int, default=16,
                   help="latent spatial size for random mode (16 -> 256px @f16)")
    p.add_argument("--steps", type=int, default=8, help="interpolation steps")
    p.add_argument("--image", default=None, help="input image (reconstruct)")
    p.add_argument("--image_b", default=None, help="second image (interpolate)")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", default="generated")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "interpolate" and not (args.image and args.image_b):
        raise SystemExit("--mode interpolate needs --image and --image_b")
    if args.mode == "reconstruct" and not args.image:
        raise SystemExit("--mode reconstruct needs --image")

    import torch

    from ..data import preprocess_file
    from ..evaluation import generate_interpolation, generate_random, reconstruct
    from ..utils.image import make_grid, save_image
    from .evaluate import load_model

    model = load_model(args, "generate")
    device = next(model.parameters()).device
    os.makedirs(args.output_dir, exist_ok=True)
    if args.mode == "random":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        imgs = generate_random(model, None, gen, args.num_samples, args.latent_hw)
        save_image(make_grid(imgs), os.path.join(args.output_dir, "random.png"))
        for i, img in enumerate(imgs):
            save_image(img, os.path.join(args.output_dir, f"sample_{i:03d}.png"))
    elif args.mode == "interpolate":
        a = preprocess_file(args.image, args.resolution)
        b = preprocess_file(args.image_b, args.resolution)
        imgs = generate_interpolation(model, None, a, b, args.steps)
        save_image(make_grid(imgs, nrow=args.steps),
                   os.path.join(args.output_dir, "interpolation.png"))
    else:
        x = preprocess_file(args.image, args.resolution)[None]
        recon = reconstruct(model, None, x)
        save_image(make_grid(np.concatenate([x, recon], axis=0), nrow=2),
                   os.path.join(args.output_dir, "reconstruction.png"))
    print(f"[generate] wrote outputs to {args.output_dir}")


if __name__ == "__main__":
    main()
