"""LM training (port of ``repro/train``): the train-step factory, AdamW
with global-norm clipping and the warmup-cosine schedule."""
from repro_torch.train.loop import (
    TrainState, make_train_step, train_state_specs,
)
from repro_torch.train.optimizer import adamw_init, adamw_update
from repro_torch.train.schedule import cosine_warmup

__all__ = ["TrainState", "make_train_step", "train_state_specs",
           "adamw_init", "adamw_update", "cosine_warmup"]
