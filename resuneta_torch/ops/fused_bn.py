"""BatchNorm apply and the eval affine (resuneta_tpu/ops/fused_bn.py,
models/norm.py:70-75).

Eval folds BN into a per-channel affine y = x*a + b of the running
statistics, formed in f32 in the reference's order of operations:
a = scale * rsqrt(var + eps), b = bias - mean * scale * rsqrt(var + eps).
Batch statistics and the closed-form backward arrive with the training
slice.
"""

import torch


def bn_affine(scale, bias, mean, var, eps=1e-3):
    """(a, b) of y = x*a + b from BN parameters and running statistics."""
    invstd = torch.rsqrt(var + eps)
    return scale * invstd, bias - mean * scale * invstd


def batch_norm_act(x, gamma, beta, mean, var, *, eps=1e-3, relu=False):
    """y = relu?((x - mean) * rsqrt(var+eps) * gamma + beta) over the last
    (channel) axis of x, with the f32 (C,)-vector affine folded to one
    multiply-add in x.dtype, as the reference's apply does."""
    invstd = torch.rsqrt(var + eps)
    a = (gamma * invstd).to(x.dtype)
    b = (beta - mean * gamma * invstd).to(x.dtype)
    y = x * a + b
    if relu:
        y = torch.clamp_min(y, 0)
    return y
