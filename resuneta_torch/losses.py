"""Losses with Keras-compatible numerics and reductions
(resuneta_tpu/losses.py).

Every loss computes in float32 whatever the model's compute dtype. Per-head
scalars use Keras' sum_over_batch_size reduction (the mean over every
element of the per-sample loss), so the multitask total
  total = seg + bound_weight*bound + dist_weight*dist + color_weight*color
matches model.compile(loss=..., loss_weights=...) in the reference
(train_ISPRS.py:437-452). Tensors are NHWC, as the model's outputs.
"""

import torch

from .parallel import axis

_KERAS_EPS = 1e-7  # K.epsilon()


def tanimoto_loss(label, pred):
    """Tanimoto coefficient with inverse-squared-volume class weights
    (multitasking_utils.py:38-68). label, pred: (B, H, W, C); returns the
    per-sample coefficients (B,). The weights come from `label`, whatever
    it is: the dual passes the predictions there on purpose, and then the
    weights carry gradient. Inside a data-parallel step the volumes are
    the global batch's (pmean over the ranks, losses.py:29-34), and then
    their gradient goes back through the all-reduce. Over a space axis
    each rank holds a band of rows: the sums over H, W add the bands'
    (psum over space), so every rank of a row computes its whole-image
    coefficient."""
    label = label.float()
    pred = pred.float()
    smooth = 1e-5
    # (B, C) sums over H, W: over a space axis the bands' sums added
    vol, sum_square, sum_product = axis.psum(
        (label.sum(dim=(1, 2)), (pred * pred + label * label).sum(dim=(1, 2)),
         (pred * label).sum(dim=(1, 2))), axes=("space",))
    vli = axis.pmean(vol.mean(dim=0), axes=("data",))  # (C,) volumes
    wli = 1.0 / vli ** 2                            # inf where a volume is 0
    inf = torch.isinf(wli)
    # NiftyNet's handling: an inf weight becomes the largest finite one
    finite = torch.where(inf, torch.zeros_like(wli), wli)
    wli = torch.where(inf, torch.ones_like(wli) * finite.max(), wli)
    numerator = (wli * sum_product).sum(dim=-1)
    denominator = (wli * (sum_square - sum_product)).sum(dim=-1)
    return (numerator + smooth) / (denominator + smooth)


def tanimoto_dual_loss(label, pred):
    """1 - 0.5*(T(pred as label, label as pred) + T(1-label, 1-pred)), the
    swapped arguments of multitasking_utils.py:71-85 kept; the Keras mean
    over the batch."""
    loss1 = tanimoto_loss(pred, label)
    loss2 = tanimoto_loss(1.0 - label, 1.0 - pred)
    return (1.0 - 0.5 * (loss1 + loss2)).mean()


def weighted_categorical_crossentropy(weights):
    """utils.py:466-491: renormalised, clipped probabilities,
    -sum(w*y*log p) per pixel, mean over B*H*W."""
    weights = torch.as_tensor(weights, dtype=torch.float32)

    def loss(y_true, y_pred):
        y_true = y_true.float()
        y_pred = y_pred.float()
        y_pred = y_pred / y_pred.sum(dim=-1, keepdim=True)
        y_pred = y_pred.clamp(_KERAS_EPS, 1.0 - _KERAS_EPS)
        w = weights.to(y_pred.device)
        return (-(y_true * torch.log(y_pred) * w).sum(dim=-1)).mean()

    return loss


def categorical_crossentropy(y_true, y_pred):
    """Keras CategoricalCrossentropy on probabilities."""
    y_true = y_true.float()
    y_pred = y_pred.float()
    y_pred = y_pred / y_pred.sum(dim=-1, keepdim=True)
    y_pred = y_pred.clamp(_KERAS_EPS, 1.0 - _KERAS_EPS)
    return (-(y_true * torch.log(y_pred)).sum(dim=-1)).mean()


def binary_crossentropy(y_true, y_pred):
    """Keras BinaryCrossentropy on probabilities: elementwise, mean over the
    last axis, then over everything."""
    y_true = y_true.float()
    y_pred = y_pred.float().clamp(_KERAS_EPS, 1.0 - _KERAS_EPS)
    bce = -(y_true * torch.log(y_pred) + (1.0 - y_true) * torch.log(1.0 - y_pred))
    return bce.mean(dim=-1).mean()


def mean_squared_error(y_true, y_pred):
    """Keras MeanSquaredError: mean over the last axis, then overall."""
    d = y_true.float() - y_pred.float()
    return (d * d).mean(dim=-1).mean()


# ISPRS fixed WCE weights (train_ISPRS.py:424)
ISPRS_WCE_WEIGHTS = (4.34558461, 2.97682037, 3.92124661, 5.67350328,
                     374.0300152)


def make_losses(loss_name, num_classes=None, wce_weights=None):
    """train_ISPRS.py:411-429: {seg, bound, dist, color} -> scalar loss fn."""
    if loss_name == "cross_entropy":
        return {"seg": categorical_crossentropy, "bound": binary_crossentropy,
                "dist": mean_squared_error, "color": mean_squared_error}
    if loss_name == "tanimoto":
        return {h: tanimoto_dual_loss
                for h in ("seg", "bound", "dist", "color")}
    if loss_name == "weighted_cross_entropy":
        w = wce_weights if wce_weights is not None else ISPRS_WCE_WEIGHTS
        return {"seg": weighted_categorical_crossentropy(w),
                "bound": binary_crossentropy, "dist": mean_squared_error,
                "color": mean_squared_error}
    raise ValueError(f"unknown loss {loss_name}")
