from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.training.train_step import TrainState, init_train_state, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "TrainState",
    "make_train_step",
    "init_train_state",
]
