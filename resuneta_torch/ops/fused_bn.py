"""BatchNorm statistics, apply with the closed-form backward, and the eval
affine (resuneta_tpu/ops/fused_bn.py, models/norm.py:70-75).

Every function takes the channel axis last (NHWC), as the reference does.

Train mode: `bn_stats` gives the f32 batch mean and the fast (biased)
variance E[x²] − mean²; `bn_apply` normalises with them and has the
reference's closed-form VJP (fused_bn.py:86-130): the ReLU mask is
recomputed in x's dtype, and dmean, dvar flow on through autograd into
`bn_stats`, so a statistics pass shared by several applies gets every
cotangent. Sync-BN (fused_bn.py:44-49): inside a data-parallel step
(parallel/axis.py; over a space axis too, every band the same size)
`bn_stats` pmeans the raw moments over the ranks before
forming the variance, so every consumer (BnApply, K1's affine, K2's folded
dmean/dvar through the all-reduce's backward) sees the global batch's
statistics.

Eval folds BN into a per-channel affine y = x*a + b of the running
statistics, formed in f32 in the reference's order of operations:
a = scale * rsqrt(var + eps), b = bias - mean * scale * rsqrt(var + eps).
"""

import torch

from ..parallel import axis


def bn_stats(x):
    """(mean, var) over every axis but the last, f32, var = E[x²] − mean²
    (flax's fast variance), of the global batch inside a data-parallel
    step. Differentiable: call once and share."""
    dims = tuple(range(x.dim() - 1))
    xs = x.float()
    mean, msq = axis.pmean((xs.mean(dims), (xs * xs).mean(dims)))
    return mean, msq - mean * mean


def bn_affine(scale, bias, mean, var, eps=1e-3):
    """(a, b) of y = x*a + b from BN parameters and running statistics."""
    invstd = torch.rsqrt(var + eps)
    return scale * invstd, bias - mean * scale * invstd


def _apply(x, gamma, beta, mean, var, eps, relu):
    invstd = torch.rsqrt(var + eps)
    a = (gamma * invstd).to(x.dtype)
    b = (beta - mean * gamma * invstd).to(x.dtype)
    y = x * a + b
    if relu:
        y = torch.clamp_min(y, 0)
    return y


class BnApply(torch.autograd.Function):
    """y = relu?((x − mean)·rsqrt(var+eps)·γ + β) with the closed-form
    backward of fused_bn.py:103-127."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, eps, relu):
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.relu = eps, relu
        return _apply(x, gamma, beta, mean, var, eps, relu)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dims = tuple(range(x.dim() - 1))
        invstd = torch.rsqrt(var + ctx.eps)
        if ctx.relu:
            # the mask recomputed from the forward's expression and dtype
            a = (gamma * invstd).to(x.dtype)
            b = (beta - mean * gamma * invstd).to(x.dtype)
            g = torch.where(x * a + b > 0, g, torch.zeros((), dtype=g.dtype,
                                                           device=g.device))
        gf = g.float()
        xhat = (x.float() - mean) * invstd
        dbeta = gf.sum(dims)
        dgamma = (gf * xhat).sum(dims)
        dmean = -gamma * invstd * dbeta
        dvar = -0.5 * gamma * invstd * invstd * dgamma
        dx = (g * (gamma * invstd).to(g.dtype)).to(x.dtype)
        return dx, dgamma, dbeta, dmean, dvar, None, None


def bn_apply(x, gamma, beta, mean, var, *, eps=1e-3, relu=False):
    """Train-mode BN(+ReLU) over the last axis with the closed-form VJP."""
    return BnApply.apply(x, gamma, beta, mean, var, eps, relu)


def batch_norm_act(x, gamma, beta, mean, var, *, eps=1e-3, relu=False):
    """y = relu?((x - mean) * rsqrt(var+eps) * gamma + beta) over the last
    (channel) axis of x, with the f32 (C,)-vector affine folded to one
    multiply-add in x.dtype, as the reference's apply does. No custom
    backward: the eval path."""
    return _apply(x, gamma, beta, mean, var, eps, relu)
