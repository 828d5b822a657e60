from .diffusion import (LatentStats, encode_to_latents, generate_images, generation_fid,
                        make_dit_train_step, make_sampler, rectified_flow_loss)
from .checkpoint import (latest_step, load_config, restore_checkpoint, restore_model_params,
                         save_checkpoint)
from .optim import Adafactor, AdamW, make_optimizer
from .schedule import warmup_constant, warmup_cosine
from .train_step import (TrainState, make_eval_step, make_gan_train_step, make_train_step,
                         make_vf_proj_params)
from .trainer import Trainer, TrainerConfig

__all__ = ["AdamW", "Adafactor", "make_optimizer", "make_vf_proj_params",
           "restore_model_params", "warmup_constant", "warmup_cosine",
           "TrainState", "make_train_step", "make_gan_train_step", "make_eval_step", "save_checkpoint",
           "restore_checkpoint", "latest_step", "load_config", "Trainer",
           "TrainerConfig", "LatentStats", "rectified_flow_loss", "make_dit_train_step",
           "make_sampler", "generate_images", "generation_fid", "encode_to_latents"]
