"""BatchNorm with the reference's names and constants
(resuneta_tpu/models/norm.py).

Parameters `scale`, `bias` and buffers `mean`, `var` (float32), eps 1e-3,
momentum 0.99 in Keras' sense (running = 0.99 * running + 0.01 * batch, with
the biased batch variance). These names are what the Flax converter maps
onto. This slice runs eval only: the affine of the running statistics;
batch statistics arrive with the training slice.
"""

import torch
from torch import nn

from ..ops.fused_bn import batch_norm_act, bn_affine


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-3, act: bool = False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.act = act
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self):
        """(a, b) of the eval-mode y = x*a + b, f32 (C,) vectors."""
        return bn_affine(self.scale, self.bias, self.mean, self.var,
                         self.epsilon)

    def forward(self, x):
        """Eval apply on an NCHW (channels_last) tensor, fused ReLU if act."""
        if self.training:
            raise NotImplementedError(
                "batch statistics arrive with the training slice; call "
                ".eval()")
        y = batch_norm_act(x.permute(0, 2, 3, 1), self.scale, self.bias,
                           self.mean, self.var, eps=self.epsilon,
                           relu=self.act)
        return y.permute(0, 3, 1, 2)
