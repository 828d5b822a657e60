"""Training CLI (PyTorch port of ``cli/train.py``): the same flags, stages 1
and 2 on one CUDA device.

Usage:
  # Stage 1 on a folder of images (ImageFolder layout; a COCO root or
  # hf:<dataset> also work)
  python -m deepl_project_tpu_torch.cli.train --variant large --data /data/images \
      --batch_size 16 --accum_steps 2 --num_epochs 1 --steps_per_epoch 20 \
      --output_dir out/
  # The repo's stage-1 recipe (batch 8 in 4 microbatches, L1 + LPIPS + KL +
  # VF 0.1; the VF teacher is DINOv2 where its weights are on this machine,
  # else a deterministic stub)
  python -m deepl_project_tpu_torch.cli.train \
      --config configs/transvae_large_f16d32.yaml --output_dir out/
  # Gradient checkpointing and Adafactor (batch 16 in one microbatch)
  python -m deepl_project_tpu_torch.cli.train --variant large \
      --gradient_checkpointing --optimizer adafactor --batch_size 16 ...
  # The big-model recipe: each stage's blocks in the stacked (scan) layout,
  # whose Adafactor clips a stage's stacked update as one block
  python -m deepl_project_tpu_torch.cli.train --variant large \
      --gradient_checkpointing --scan_blocks --optimizer adafactor ...
  # Stage 2: GAN finetune with a frozen encoder, resuming the stage-1
  # checkpoint in the same --output_dir (the GAN term needs --gan_weight > 0)
  python -m deepl_project_tpu_torch.cli.train --variant large --use_gan \
      --freeze_encoder --gan_weight 0.05 --gan_r1_gamma 10 --ema_decay 0.999 \
      --batch_size 8 --output_dir out/

Data-, FSDP- and tensor-parallel training runs under torchrun, one process
a rank (NCCL between CUDA devices, gloo with ``--device cpu``): the ranks
form a (data, 1, --mesh_model) mesh and --param_sharding places the
parameters (replicate | fsdp | tensor), as in the JAX CLI; --batch_size is
the global batch, and each rank decodes only its rows of it (hf:
sources read their ``ds.shard`` of the data coordinate instead). A batch
that does not split over world / --mesh_model data ranks trains on the JAX
trainer's subset mesh, the first gcd(batch, world / mesh_model) x
mesh_model ranks; the others wait for them and exit 0:

  python -m torch.distributed.run --nproc_per_node 4 \
      -m deepl_project_tpu_torch.cli.train --variant huge --mesh_model 2 \
      --param_sharding fsdp --batch_size 16 ...

TensorBoard, history.jsonl, run_args.json and the checkpoints are written
by rank 0. --mesh_model > 1 outside torchrun exits non-zero.

``--device cpu`` runs the plain PyTorch path. As in the JAX CLI, the yaml's
``training.gradient_checkpointing`` is not read: pass
--gradient_checkpointing. It checkpoints under remat policy 'none' where the
JAX CLI keeps 'dots' (``CLI_REMAT_POLICY``). A path's images decode on
``--num_workers`` threads (-1: min(cpu_count, 16)) and repeat over epochs;
with --eval_every_steps the validation batches are the source's first
batches (for a folder, the first training images: the JAX CLI's choice).
--scan_blocks holds each stage's blocks in the JAX package's stacked layout
(``ops.stack``; its checkpoints keep that layout and serve as they are),
under every --param_sharding.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..config import get_config
from ..data import batch_iterator, input_pipeline, make_dataset, row_filter
from ..losses import LossWeights
from ..losses.teachers import make_vf_teacher
from ..models.transvae import resolve_device
from ..parallel import host_shard_info, initialize_multihost, under_torchrun
from ..training.trainer import Trainer, TrainerConfig
from ..utils.logging import is_primary

# The remat policy --gradient_checkpointing selects. The JAX CLI leaves the
# config's 'dots'; on an H100 'none' (each block's input kept, the rest
# recomputed) is both faster and smaller than every selective policy, whose
# dispatch mode costs more host time than the matmuls it saves (PERF.md,
# section 6: b8 @256, 'none' 1.27-1.39x no remat's time at 12.55 GiB,
# 'dots' 1.55-2.05x at 15.15 GiB).
CLI_REMAT_POLICY = "none"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train TransVAE (PyTorch, CUDA)")
    # Model
    p.add_argument("--variant", default="tiny",
                   choices=["tiny", "base", "large", "huge", "giant"])
    p.add_argument("--compression_ratio", type=int, default=16, choices=[8, 16])
    p.add_argument("--latent_dim", type=int, default=None)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="per-block gradient checkpointing (remat, policy "
                        f"{CLI_REMAT_POLICY!r})")
    p.add_argument("--norm_latents", action="store_true", default=True,
                   help="GroupNorm before the latent heads")
    p.add_argument("--no_norm_latents", dest="norm_latents", action="store_false")
    p.add_argument("--scan_blocks", action="store_true",
                   help="each stage's blocks as one stack of parameters with a "
                        "leading depth axis (the JAX scan layout)")
    p.add_argument("--attention_impl", default="auto_train",
                   choices=["auto", "auto_train", "xla", "xla_chunked", "pallas"],
                   help="attention dispatch; 'auto_train' takes the flash "
                        "kernels from N=4096, whose backward saves O(N)")
    p.add_argument("--mu_dtype", default=None, choices=[None, "bfloat16"],
                   help="AdamW first-moment dtype")
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"],
                   help="'adafactor': factored second moment, no first moment")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    # Data
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', 'shapes', 'hf:<dataset>', or a local path "
                        "(a COCO root or a folder of images)")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=-1,
                   help="parallel decode threads for folder/COCO/hf: sources; "
                        "-1 = min(cpu_count, 16)")
    # Training
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=10_000)
    p.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--skip_data_on_resume", action="store_true")
    # Losses
    p.add_argument("--l1_weight", type=float, default=1.0)
    p.add_argument("--lpips_weight", type=float, default=1.0)
    p.add_argument("--perceptual", default="vgg", choices=["vgg", "self"],
                   help="'self': the frozen encoder of --perceptual_checkpoint in "
                        "the LPIPS slot (not VGG-LPIPS)")
    p.add_argument("--perceptual_checkpoint", default="",
                   help="checkpoint directory of a trained model (perceptual self)")
    p.add_argument("--kl_weight", type=float, default=1e-8)
    p.add_argument("--vf_weight", type=float, default=0.0,
                   help="VF alignment to the --dino_model teacher (a deterministic "
                        "stub where its weights are not on this machine)")
    p.add_argument("--gan_weight", type=float, default=0.0)
    # Stage 2
    p.add_argument("--use_gan", action="store_true",
                   help="train with the PatchGAN discriminator at --gan_weight")
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--gan_adaptive_weight", action="store_true")
    p.add_argument("--gan_warmup_steps", type=int, default=0)
    p.add_argument("--gan_ramp_steps", type=int, default=1)
    p.add_argument("--gan_adaptive_max", type=float, default=1.0)
    p.add_argument("--gan_disc_loss_floor", type=float, default=0.6)
    p.add_argument("--gan_r1_gamma", type=float, default=10.0)
    p.add_argument("--divergence_halt_db", type=float, default=5.0)
    p.add_argument("--divergence_patience", type=int, default=3)
    # Infra
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--save_every_epochs", type=int, default=5)
    p.add_argument("--save_every_steps", type=int, default=0)
    p.add_argument("--eval_every_steps", type=int, default=0)
    p.add_argument("--val_batches", type=int, default=4)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--no_keep_best", action="store_true")
    p.add_argument("--dino_model", default="facebook/dinov2-base")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel axis size (under torchrun)")
    p.add_argument("--param_sharding", default="replicate",
                   choices=["replicate", "fsdp", "tensor"])
    return p


def load_yaml_config(path: str, args: argparse.Namespace) -> dict:
    """The model/training/losses sections; the model section takes
    precedence over flags (as in the JAX CLI)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    for key in ("variant", "compression_ratio", "latent_dim", "norm_latents",
                "scan_blocks"):
        if key in raw.get("model", {}):
            setattr(args, key, raw["model"][key])
    for src, dst in [("batch_size", "batch_size"), ("learning_rate", "lr"),
                     ("warmup_steps", "warmup_steps"), ("num_epochs", "num_epochs"),
                     ("gradient_accumulation", "accum_steps")]:
        if src in raw.get("training", {}):
            setattr(args, dst, raw["training"][src])
    for src, dst in [("l1", "l1_weight"), ("lpips", "lpips_weight"), ("kl", "kl_weight"),
                     ("vf", "vf_weight"), ("gan", "gan_weight")]:
        if src in raw.get("losses", {}):
            setattr(args, dst, raw["losses"][src])
    return raw


SYNTHETIC_SOURCES = ("synthetic", "shapes")


def source_kwargs(data: str, num_workers: int) -> dict:
    """The training source's keywords, as the JAX CLI passes them:
    ``num_workers`` -1 is min(cpu_count, 16); a path repeats over epochs."""
    workers = min(os.cpu_count() or 1, 16) if num_workers < 0 else num_workers
    if data in SYNTHETIC_SOURCES:
        return {"num_samples": 10 ** 9}
    if data.startswith("hf:"):
        return {"num_workers": workers}
    return {"repeat": True, "num_workers": workers}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.config:
        load_yaml_config(args.config, args)
    if args.mesh_model > 1 and not under_torchrun():
        sys.exit(f"--mesh_model {args.mesh_model} needs a model group of that many ranks: "
                 "launch under torchrun (python -m torch.distributed.run)")
    # Under torchrun: the process group, and this rank's device.
    device = (initialize_multihost(device=args.device)["device"] if under_torchrun()
              else resolve_device(args.device))

    # Provenance: the resolved flags of every invocation, never overwritten
    # (rank 0's).
    os.makedirs(args.output_dir, exist_ok=True)
    if is_primary():
        prov = os.path.join(args.output_dir, "run_args.json")
        n = 1
        while os.path.exists(prov):
            prov = os.path.join(args.output_dir, f"run_args.{n}.json")
            n += 1
        with open(prov, "w") as f:
            json.dump({"argv": sys.argv[1:] if argv is None else list(argv),
                       "args": vars(args)}, f, indent=1)

    model_cfg = get_config(args.variant, args.compression_ratio, args.latent_dim,
                           remat=args.gradient_checkpointing,
                           remat_policy=CLI_REMAT_POLICY,
                           norm_latents=args.norm_latents,
                           attention_impl=args.attention_impl,
                           scan_blocks=args.scan_blocks)
    weights = LossWeights(l1=args.l1_weight, lpips=args.lpips_weight,
                          kl=args.kl_weight, vf=args.vf_weight,
                          gan=args.gan_weight if args.use_gan else 0.0)
    train_cfg = TrainerConfig(
        batch_size=args.batch_size, accum_steps=args.accum_steps,
        learning_rate=args.lr, warmup_steps=args.warmup_steps,
        num_epochs=args.num_epochs, steps_per_epoch=args.steps_per_epoch,
        freeze_encoder=args.freeze_encoder, weights=weights,
        use_lpips=args.lpips_weight > 0, resolution=args.resolution,
        seed=args.seed, log_every=args.log_every,
        save_every_epochs=args.save_every_epochs,
        save_every_steps=args.save_every_steps,
        eval_every_steps=args.eval_every_steps, output_dir=args.output_dir,
        mu_dtype=args.mu_dtype, optimizer=args.optimizer,
        ema_decay=args.ema_decay, keep_best=not args.no_keep_best,
        gan_adaptive_weight=args.gan_adaptive_weight, perceptual=args.perceptual,
        perceptual_checkpoint=args.perceptual_checkpoint,
        gan_warmup_steps=args.gan_warmup_steps, gan_ramp_steps=args.gan_ramp_steps,
        gan_adaptive_max=args.gan_adaptive_max,
        gan_disc_loss_floor=args.gan_disc_loss_floor, gan_r1_gamma=args.gan_r1_gamma,
        lr_schedule=args.lr_schedule,
        skip_data_on_resume=args.skip_data_on_resume,
        divergence_halt_db=args.divergence_halt_db,
        divergence_patience=args.divergence_patience,
        mesh_model=args.mesh_model, param_sharding=args.param_sharding)
    # The VF teacher (the yaml's stage-1 recipe sets vf 0.1): DINOv2 where its
    # weights are on this machine, else the deterministic stub.
    teacher_fn = make_vf_teacher(args.dino_model, device=device) if args.vf_weight > 0 else None
    trainer = Trainer(model_cfg, train_cfg, teacher_fn=teacher_fn, device=device)
    if trainer.outside:  # left out of a subset mesh: wait for its ranks, then exit 0
        trainer.fit(iter(()))
        return

    val_batches = None
    if args.eval_every_steps > 0:
        # A held-out slice for synthetic sources (another seed); for the
        # others, the first batches of the same source, as the JAX CLI makes.
        val_kw = {"resolution": args.resolution}
        if args.data in SYNTHETIC_SOURCES:
            val_kw.update(seed=1234, num_samples=args.val_batches * args.batch_size)
        val_src = make_dataset(args.data, **val_kw)
        val_batches = [b for _, b in zip(range(args.val_batches),
                                         batch_iterator(val_src, args.batch_size))]
    # Under a mesh each data rank reads its rows of every global batch (hf:
    # its ds.shard), model-axis peers the same rows.
    index, shards = host_shard_info(trainer.mesh)
    kw = source_kwargs(args.data, args.num_workers)
    if shards > 1 and args.data.startswith("hf:"):
        kw.update(shard_index=index, num_shards=shards)
    elif shards > 1:
        accum = 1 if trainer.use_gan else args.accum_steps
        kw["keep"] = row_filter(args.batch_size, accum, index, shards)
    source = make_dataset(args.data, resolution=args.resolution, **kw)
    data = input_pipeline(source, args.batch_size // shards, trainer.device)
    trainer.fit(data, val_batches=val_batches)


if __name__ == "__main__":
    main()
