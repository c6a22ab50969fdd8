"""The reference's losses and optimizer, float32 (upstream
multitasking_utils.py Tanimoto_dual_loss, utils.py
weighted_categorical_crossentropy; Keras' reductions) and Adam as Keras
and optax define it (b1 0.9, b2 0.999, eps 1e-8 outside the root of the
bias-corrected second moment)."""

import torch

KERAS_EPS = 1e-7


def tanimoto(label, pred):
    """Per-sample Tanimoto coefficient with inverse-squared-volume class
    weights; (B, H, W, C) -> (B,)."""
    vol = label.sum(dim=(1, 2))
    sum_square = (pred * pred + label * label).sum(dim=(1, 2))
    sum_product = (pred * label).sum(dim=(1, 2))
    w = 1.0 / vol.mean(dim=0) ** 2
    inf = torch.isinf(w)
    finite_max = torch.where(inf, torch.zeros_like(w), w).max()
    w = torch.where(inf, finite_max, w)
    num = (w * sum_product).sum(dim=-1)
    den = (w * (sum_square - sum_product)).sum(dim=-1)
    return (num + 1e-5) / (den + 1e-5)


def tanimoto_dual(label, pred):
    """1 - (T(pred as label, label) + T(1 - label, 1 - pred)) / 2, averaged
    over the batch (the upstream's argument order kept)."""
    return (1.0 - 0.5 * (tanimoto(pred, label) +
                         tanimoto(1.0 - label, 1.0 - pred))).mean()


def wce(weights):
    w = torch.as_tensor(weights, dtype=torch.float32)

    def loss(y_true, y_pred):
        p = y_pred / y_pred.sum(dim=-1, keepdim=True)
        p = p.clamp(KERAS_EPS, 1.0 - KERAS_EPS)
        return (-(y_true * torch.log(p) * w.to(p.device)).sum(dim=-1)).mean()

    return loss


def total_loss(cfg, out, batch):
    """The weighted sum of the configuration's head losses."""
    if cfg["loss"] == "tanimoto":
        fns = {h: tanimoto_dual for h in cfg["loss_weights"]}
    else:
        fns = {h: wce(cfg["class_weights"]) for h in cfg["loss_weights"]}
    return sum(fns[h](batch[h], out[h]) * w
               for h, w in cfg["loss_weights"].items())


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = \
            params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v = self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            self.params[k].sub_(self.lr * (m / c1) /
                                (torch.sqrt(v / c2) + self.eps))
