"""Training: AdamW with float32 master weights and the train-step factory
(the reference's `repro.train`)."""

from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    lr_schedule,
)
from repro_torch.train.train_step import make_train_step

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "lr_schedule",
           "make_train_step"]
