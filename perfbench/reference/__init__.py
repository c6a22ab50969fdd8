"""The benchmark's plain reference: float32 PyTorch and NumPy only. It
imports nothing of the program and takes none of its outputs as inputs:
the weights and the raw batches are the benchmark's, made from the seed,
and the labels and normalisation are worked out here again."""

import torch

from . import labels
from .losses import Adam, total_loss
from .model import ResUnetA, layout
from .precision import Precision


def model_batch(cfg, raw, device):
    """The reference's model batch of one raw batch of the traffic."""
    t = {k: torch.as_tensor(v).to(device) for k, v in raw.items()}
    if "image_u8" in t:
        return labels.isprs_batch(t["image_u8"], t["label_ids"], t["aug"],
                                  cfg["num_classes"])
    return labels.amazon_batch(t["image"], t["seg"])


def param_names(cfg):
    """The trained leaves: every layout entry but the BN running
    statistics."""
    return [n for n, _, _ in layout(cfg)
            if not n.endswith((".mean", ".var"))]


def train_steps(cfg, weights, raws, mode="f32", device="cuda"):
    """Adam steps of the configuration's loss from `weights` over the raw
    batches `raws`. Returns {"losses": [float], "grad_norms": {leaf: float}
    of the first step's gradient, "change_norms": {leaf: float} of the
    parameters' change over all the steps}."""
    prec = Precision(mode)
    names = param_names(cfg)
    p = {k: v.detach().to(device, torch.float32).clone()
         for k, v in weights.items()}
    start = {k: p[k].clone() for k in names}
    for k in names:
        p[k].requires_grad_(True)
    opt = Adam({k: p[k] for k in names}, cfg["learning_rate"])
    losses, grad_norms = [], None
    with prec.scope():
        for raw in raws:
            batch = model_batch(cfg, raw, device)
            out = ResUnetA(cfg, p, train=True, prec=prec)(batch["image"])
            loss = total_loss(cfg, out, batch)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [p[k] for k in names])))
            if grad_norms is None:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            opt.step(grads)
            losses.append(float(loss.detach()))
            del out, loss, grads, batch
    change = {k: float((p[k].detach() - start[k]).norm()) for k in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


@torch.no_grad()
def bn_statistics(cfg, weights, images, device="cuda"):
    """{BatchNorm name: (mean, biased variance)} of a train-mode forward of
    float32 NHWC images: the running statistics that a model trained on
    such inputs holds."""
    p = {k: v.to(device, torch.float32) for k, v in weights.items()}
    stats = {}
    with Precision("f32").scope():
        ResUnetA(cfg, p, train=True, stats=stats)(
            torch.as_tensor(images).to(device).float())
    return stats


@torch.no_grad()
def eval_logits(cfg, weights, images, mode="f32", chunk=16, device="cuda"):
    """The eval-mode seg logits (N, H, W, C) of float32 NHWC images, in
    chunks of patches."""
    prec = Precision(mode)
    p = {k: v.to(device, torch.float32) for k, v in weights.items()}
    outs = []
    with prec.scope():
        for i in range(0, images.shape[0], chunk):
            x = torch.as_tensor(images[i:i + chunk]).to(device).float()
            outs.append(ResUnetA(cfg, p, train=False, prec=prec)(x)
                        ["seg_logits"])
    return torch.cat(outs)
