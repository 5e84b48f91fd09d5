from .lora import LoraConfig, attach_lora, fold_lora, init_lora, merge_lora
from .optim import AdamW, OptimConfig, make_schedule
from .step import (
    FROZEN_BACKBONE_TRAINABLE,
    TrainConfig,
    TrainState,
    create_train_state,
    make_train_step,
)

__all__ = [
    "AdamW", "FROZEN_BACKBONE_TRAINABLE", "LoraConfig", "OptimConfig",
    "TrainConfig", "TrainState", "attach_lora", "create_train_state",
    "fold_lora", "init_lora", "make_schedule", "make_train_step",
    "merge_lora",
]
