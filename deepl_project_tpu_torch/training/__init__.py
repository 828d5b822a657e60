from .checkpoint import latest_step, load_config, restore_checkpoint, save_checkpoint
from .optim import AdamW, make_optimizer
from .schedule import warmup_constant, warmup_cosine
from .train_step import TrainState, make_eval_step, make_gan_train_step, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["AdamW", "make_optimizer", "warmup_constant", "warmup_cosine",
           "TrainState", "make_train_step", "make_gan_train_step", "make_eval_step", "save_checkpoint",
           "restore_checkpoint", "latest_step", "load_config", "Trainer",
           "TrainerConfig"]
