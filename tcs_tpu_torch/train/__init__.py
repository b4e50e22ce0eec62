"""Optimiser, schedule and the frame-window training step of the port."""

from tcs_tpu_torch.train.optim import make_optimizer, onecycle_linear_schedule
from tcs_tpu_torch.train.train_step import (
    FrameBatch,
    SequenceBatch,
    frame_losses,
    make_train_step,
)

__all__ = ["FrameBatch", "SequenceBatch", "frame_losses", "make_optimizer",
           "make_train_step", "onecycle_linear_schedule"]
