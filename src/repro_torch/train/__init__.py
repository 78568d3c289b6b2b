"""The port's training path: the synthetic data pipeline, AdamW with its
schedules, the train step (remat, microbatch accumulation) and
checkpoints in the reference's format."""
from . import checkpoint, data, optimizer, train_step
from .optimizer import OptimizerConfig, adamw_update, init_opt_state, lr_at
from .train_step import TrainState, init_state, make_loss_fn, make_train_step

__all__ = ["checkpoint", "data", "optimizer", "train_step",
           "OptimizerConfig", "adamw_update", "init_opt_state", "lr_at",
           "TrainState", "init_state", "make_loss_fn", "make_train_step"]
