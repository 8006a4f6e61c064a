from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm)
from repro_torch.train.schedule import cosine_with_warmup
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_with_warmup", "init_train_state", "make_train_step",
           "Trainer", "TrainerConfig"]
