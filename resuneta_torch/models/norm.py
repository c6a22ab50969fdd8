"""BatchNorm with the reference's names and constants
(resuneta_tpu/models/norm.py).

Parameters `scale`, `bias` and buffers `mean`, `var` (float32), eps 1e-3,
momentum 0.99 in Keras' sense: in train mode the buffers become
0.99 * running + 0.01 * batch, with the BIASED batch variance. That is not
`nn.BatchNorm2d`, whose variance is unbiased and whose momentum weighs the
batch. These names are what the Flax converter maps onto.

The module is called on NCHW (channels_last) tensors, the model's inside
layout, and hands NHWC views to ops/fused_bn.py.
"""

import contextlib
import contextvars

import torch
from torch import nn

from ..ops.fused_bn import batch_norm_act, bn_affine, bn_apply, bn_stats

_FROZEN = contextvars.ContextVar("resuneta_torch_bn_frozen", default=False)


@contextlib.contextmanager
def running_stats_frozen(frozen=True):
    """Within (where `frozen`): train-mode BNs normalise with the batch
    statistics as always but leave their running buffers as they are. A
    rematerialised block's rerun in the backward runs under it
    (models/resuneta.py `checkpointed`), so the buffers move once a
    step."""
    token = _FROZEN.set(frozen)
    try:
        yield
    finally:
        _FROZEN.reset(token)


def nhwc(x):
    """NCHW channels_last -> the NHWC view of the same bytes."""
    return x.permute(0, 2, 3, 1)


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

    def batch_stats(self, x, stats=None):
        """Train mode: the batch (mean, var) of the NCHW tensor x, or the
        given `stats` (a ResBlock's branches share their input's), and the
        running buffers' update from them (norm.py:48-60)."""
        mean, var = bn_stats(nhwc(x)) if stats is None else stats
        if _FROZEN.get():
            return mean, var
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x, stats=None, return_raw=False):
        """Apply on an NCHW (channels_last) tensor, fused ReLU if act. In
        train mode with return_raw, return (scale, bias, mean, var) for a
        consumer that fuses the normalisation (ops/convseg.FusedSegment)."""
        if not self.training:
            y = batch_norm_act(nhwc(x), self.scale, self.bias, self.mean,
                               self.var, eps=self.epsilon, relu=self.act)
            return y.permute(0, 3, 1, 2)
        mean, var = self.batch_stats(x, stats)
        if return_raw:
            return self.scale, self.bias, mean, var
        y = bn_apply(nhwc(x), self.scale, self.bias, mean, var,
                     eps=self.epsilon, relu=self.act)
        return y.permute(0, 3, 1, 2)
