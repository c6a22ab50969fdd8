"""Train state: the model (parameters and BatchNorm running statistics),
its optimizer and the step count (resuneta_tpu/train/state.py).

Optimizers match train_ISPRS.py:404-407 as the reference builds them with
optax: Adam(lr, b1=0.9, b2=0.999, eps=1e-8), with eps added outside the
square root of the bias-corrected second moment (torch.optim.Adam's rule
too), or SGD(lr, momentum=0.8), whose first step sets the momentum buffer to
the gradient (optax.trace and torch.optim.SGD alike). The learning rate can
be overridden when resuming (train_ISPRS.py:477-479).
"""

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def learning_rate(self):
        return self.optimizer.param_groups[0]["lr"]

    def override_learning_rate(self, lr):
        """Resume-time lr override (train_ISPRS.py:477-479)."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        return self


def make_optimizer(name, params, learning_rate):
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=0.8)
    raise ValueError(f"unknown optimizer {name}")


def create_train_state(model, optimizer="adam", learning_rate=1e-3):
    """The model's parameters (already on their device) under the named
    optimizer, at step 0."""
    return TrainState(model, make_optimizer(optimizer, model.parameters(),
                                            learning_rate))
