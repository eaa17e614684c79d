"""Training on torch autograd: the JAX package's ``repro.training``
(optimizer and schedules, synthetic data, train step and Trainer,
checkpointing) for the port."""

from repro_torch.training.optimizer import adamw, cosine_schedule, wsd_schedule
from repro_torch.training.train import Trainer, make_train_step

__all__ = ["adamw", "wsd_schedule", "cosine_schedule", "Trainer",
           "make_train_step"]
