from .loss import ce_loss, next_token_loss
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from .schedule import constant, warmup_cosine
from .train_step import (
    TrainConfig,
    TrainState,
    abstract_train_state,
    batch_to_device,
    init_train_state,
    make_train_step,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "TrainConfig",
    "TrainState",
    "abstract_train_state",
    "adamw_init",
    "adamw_update",
    "batch_to_device",
    "ce_loss",
    "constant",
    "global_norm",
    "init_train_state",
    "make_train_step",
    "next_token_loss",
    "warmup_cosine",
]
