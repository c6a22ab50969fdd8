"""The train state and steps (state.py, steps.py) and weights on disk
(checkpoint.py); the epoch loop and CLI arrive with a later slice."""
from .state import TrainState, create_train_state, make_optimizer
from .steps import (METRICS_MULTITASK, METRICS_SINGLE, make_eval_step,
                    make_train_step)

__all__ = ["METRICS_MULTITASK", "METRICS_SINGLE", "TrainState",
           "create_train_state", "make_eval_step", "make_optimizer",
           "make_train_step"]
