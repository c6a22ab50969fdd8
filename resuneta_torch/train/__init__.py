"""The train state and steps (state.py, steps.py), the epoch loop
(loop.py) and checkpoints (checkpoint.py)."""
from . import checkpoint
from .loop import TrainConfig, train_model
from .state import TrainState, create_train_state, make_optimizer
from .steps import (METRICS_MULTITASK, METRICS_SINGLE, make_eval_step,
                    make_train_step)

__all__ = ["METRICS_MULTITASK", "METRICS_SINGLE", "TrainConfig",
           "TrainState", "checkpoint", "create_train_state",
           "make_eval_step", "make_optimizer", "make_train_step",
           "train_model"]
