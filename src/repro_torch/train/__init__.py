"""Training: the loss, AdamW and `build_train_step`."""

from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.train.train_step import (
    TrainState,
    build_train_step,
    init_train_state,
    make_remat,
)

__all__ = [
    "AdamWState",
    "TrainState",
    "adamw_init",
    "adamw_update",
    "build_train_step",
    "cosine_schedule",
    "global_norm",
    "init_train_state",
    "make_remat",
]
