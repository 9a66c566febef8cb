"""repro_torch.training — optimizer, train step, checkpointing, fault tolerance."""

from .optimizer import OptConfig, adamw_init, adamw_update, lr_at
from .train_loop import TrainState, make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at", "make_train_step", "TrainState"]
