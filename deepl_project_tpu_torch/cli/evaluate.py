"""Evaluation CLI (PyTorch port of ``cli/evaluate.py``): reconstruction
metrics over a dataset, comparison grids and metrics.json, on one CUDA device.

Usage:
  python -m deepl_project_tpu_torch.cli.evaluate --checkpoint out/checkpoints \
      --data shapes --batch_size 16 --num_batches 4 --rfid

``--checkpoint`` is a checkpoint directory of the port's trainer (with its
``config.json``); without it the model of ``--variant`` gets random weights
from seed 0, with a warning. ``--device cpu`` runs the plain PyTorch path.
``--rfid`` adds rFID: InceptionV3 features (``rfid``) where the converted
weights are at ``utils/inception.py``'s ``DEFAULT_WEIGHTS_PATH``, else VGG
features (``vgg_rfid``, a relative metric). ``--data`` takes every source of
``data.make_dataset``: synthetic, shapes, ``hf:<name>``, a COCO root or a
folder of images (shuffled with seed 42, one pass, serial decode, as the
JAX CLI reads it).
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate TransVAE reconstructions (PyTorch)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (with config.json); random init if absent")
    p.add_argument("--variant", default="tiny")
    p.add_argument("--compression_ratio", type=int, default=16)
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', 'shapes', 'hf:<dataset>', or a local path")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_batches", type=int, default=None)
    p.add_argument("--no_lpips", action="store_true")
    p.add_argument("--rfid", action="store_true",
                   help="also compute rFID (InceptionV3 where its weights exist, "
                        "else VGG-feature vgg_rfid, a relative metric)")
    p.add_argument("--output_dir", default="eval_out")
    p.add_argument("--save_grids", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def load_model(args, tag: str):
    """The checkpoint's model, or ``--variant`` with random weights."""
    from ..evaluation import model_from_checkpoint
    from ..models import create_transvae

    if args.checkpoint:
        return model_from_checkpoint(args.checkpoint, args.device)
    model = create_transvae(args.variant, args.compression_ratio, device=args.device,
                            seed=0)
    print(f"[{tag}] WARNING: no checkpoint given -- random weights")
    return model


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data import batch_iterator, make_dataset
    from ..evaluation import evaluate_model

    model = load_model(args, "evaluate")
    batches = batch_iterator(make_dataset(args.data, resolution=args.resolution),
                             args.batch_size)
    results = evaluate_model(model, None, batches, use_lpips=not args.no_lpips,
                             max_batches=args.num_batches, compute_rfid=args.rfid,
                             output_dir=args.output_dir, save_grids=args.save_grids)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
