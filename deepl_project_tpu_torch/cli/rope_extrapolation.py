"""RoPE resolution extrapolation (PyTorch counterpart of
``scripts/reproduce/test_rope_extrapolation.py``): PSNR and SSIM (and,
with ``--rfid``, rFID: InceptionV3's where its weights exist, else on VGG
features) at 256/512/1024px from one model, printed as JSON per
resolution.

Usage:
  python -m deepl_project_tpu_torch.cli.rope_extrapolation            # card
  python -m deepl_project_tpu_torch.cli.rope_extrapolation --checkpoint ckpt/ \
      --resolutions 256 512 1024 --num_images 16 --chunk 8

The images come from ``--data`` (default ``shapes``) at the largest
resolution; the smaller ones are resized from them. Without ``--checkpoint``
the model of ``--variant`` (default large f16d32) gets random weights from
seed 0, with a warning. ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RoPE resolution-extrapolation sweep (PyTorch)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (with config.json); random init if absent")
    p.add_argument("--variant", default="large")
    p.add_argument("--compression_ratio", type=int, default=16)
    p.add_argument("--data", default="shapes")
    p.add_argument("--resolutions", type=int, nargs="+", default=[256, 512, 1024])
    p.add_argument("--num_images", type=int, default=16)
    p.add_argument("--rfid", action="store_true",
                   help="also compute (vgg_)rfid per resolution (paper Table 1 "
                        "reports rFID and PSNR per resolution)")
    p.add_argument("--chunk", type=int, default=8,
                   help="per-forward batch bound (1024px stage 2 is N=65k "
                        "tokens; a full large batch does not fit)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data import batch_iterator, make_dataset
    from ..evaluation import extrapolation_sweep
    from .evaluate import load_model

    model = load_model(args, "rope_extrapolation")
    batch = next(batch_iterator(make_dataset(args.data, resolution=max(args.resolutions)),
                                args.num_images))
    results = extrapolation_sweep(model, None, batch, tuple(args.resolutions),
                                  compute_rfid=args.rfid, chunk=args.chunk)
    out = {str(k): v for k, v in results.items()}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
