"""Dataset downloader (PyTorch port of ``cli/download.py``): stream an HF
image dataset to a class-folder JPEG tree, the layout ``--data <folder>``
of ``cli.train`` and ``cli.evaluate`` reads. The same flags and defaults;
it needs network access to the HF hub and the ``datasets`` package, which
is imported only when it runs.

    python -m deepl_project_tpu_torch.cli.download \
        --dataset evanarlian/imagenet_1k_resized_256 --split train \
        --out ./imagenet_256 --max_images 10000
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Stream HF dataset to a folder tree")
    p.add_argument("--dataset", default="evanarlian/imagenet_1k_resized_256")
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--max_images", type=int, default=None)
    args = p.parse_args(argv)

    from datasets import load_dataset

    ds = load_dataset(args.dataset, split=args.split, streaming=True)
    count = 0
    for example in ds:
        img = example.get("image") or example.get("img")
        if img is None:
            continue
        label = example.get("label", 0)
        class_dir = os.path.join(args.out, f"class_{label:04d}")
        os.makedirs(class_dir, exist_ok=True)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.save(os.path.join(class_dir, f"{count:08d}.jpg"), quality=95)
        count += 1
        if count % 1000 == 0:
            print(f"saved {count} images")
        if args.max_images and count >= args.max_images:
            break
    print(f"done: {count} images under {args.out}")


if __name__ == "__main__":
    main()
