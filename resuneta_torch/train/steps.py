"""Train and eval steps, the train_on_batch / test_on_batch equivalents
(resuneta_tpu/train/steps.py:42-78, :124-198; train_ISPRS.py:115-187).

One step over the batch on the state's device; the metric rows keep the
reference's names and order (METRICS_MULTITASK, METRICS_SINGLE). The step
factories take `device=None`, the card, and raise without one; pass
device="cpu" for the plain PyTorch path. The batch is moved to that device;
the state's model must already be there.

Data parallelism (`group=`, a parallel.mesh.DataGroup; the counterpart of
the reference's shard_map over a 'data' mesh, steps.py:81-198): each of R
ranks runs the step on its B/R rows of the global batch with the kernels
live, and the step computes what one device computes on all B rows. Its
body runs inside `parallel.axis.data_axis(group)`, so the BN statistics and
the Tanimoto class volumes are the global batch's; after the backward the
gradients are all-reduced to their mean through one flat buffer (the
reference's pmean of the gradients, steps.py:165-168); the metric row
averages the losses and the accuracy and sums the confusion counts over the
ranks (steps.py:62-78). Every rank then holds the same parameters.

Height sharding (`group=` a parallel.mesh.SpaceMesh of n_data x n_space
ranks with n_space > 1; the reference's GSPMD over a (data, space) mesh,
steps.py:84-125): each rank holds B/n_data rows and a band of H/n_space
rows of each (parallel.mesh.shard_batch_spatial). The body runs inside
both axes, so the models' 3x3 convs read halos and the reductions span
the axes they must (parallel/axis.py), and inside `convseg.disabled()`,
so K1-K4 are off and the model takes its NHWC routing, as the reference
traces GSPMD programs (resuneta_tpu/parallel/mesh.py:18-36). The input
pipeline needs whole planes (rot90, Canny, the EDT): the step gathers its
rows' raw uint8 bands over space, runs `preprocess` on the whole planes
(K5/K6 live) and keeps its band of every head, which is what GSPMD makes
of the reference's vmapped pipeline. The gradients are averaged and the
row reduced over every rank. A mesh with n_space == 1 is the data axis
alone, kernels live.

Rematerialisation (`remat=True`; the reference's jax.checkpoint of the
forward under SAVE_CONVS, steps.py:31-40, :151-152): each block of the
forward (models/resuneta.py `checkpointed`: the ResBlocks, PSPs,
UpSampleConvs, Combines and the heads) runs under non-reentrant
torch.utils.checkpoint with the selective policy `SAVE_CONVS`, which keeps
the outputs of the convolutions and pools that run as PyTorch ops and the
BN moments, and frees everything elementwise (BN applies, ReLUs, residual
sums, concats, upsamples, the f32 copies the BN statistics read) to be
recomputed just before the block's backward. The hand-written kernels'
outputs (K1, K3, K4 on the card) are not PyTorch ops: their forwards run
again in the rerun. The rerun leaves the BN running buffers alone and
reduces sync-BN's moments over the same ranks again, so the step's numbers
are those of the step without remat; its memory is less.
"""

import contextlib
from typing import Dict

import torch
from torch.utils.checkpoint import CheckpointPolicy

from ..device import resolve_device
from ..metrics import binary_counts, categorical_accuracy
from ..models.resuneta import remat as remat_scope
from ..ops import convseg
from ..parallel import axis

# the ops whose outputs a rematerialised block keeps (the reference's
# _save tags, models/resuneta.py:44-51: conv and pool outputs, BN
# statistics)
SAVED_OPS = (torch.ops.aten.convolution.default,
             torch.ops.aten.max_pool2d_with_indices.default,
             torch.ops.aten.mean.dim)


def SAVE_CONVS(ctx, op, *args, **kwargs):
    """The selective checkpoint policy of remat=True: keep SAVED_OPS'
    outputs, recompute every other op."""
    return CheckpointPolicy.MUST_SAVE if op in SAVED_OPS else \
        CheckpointPolicy.PREFER_RECOMPUTE

METRICS_MULTITASK = [
    "loss", "seg_loss", "bound_loss", "dist_loss", "color_loss",
    "seg_accuracy", "seg_true_positives", "seg_false_positives",
    "seg_true_negatives", "seg_false_negatives",
]
METRICS_SINGLE = [
    "loss", "accuracy", "true_positives", "false_positives",
    "true_negatives", "false_negatives",
]


def _multitask_total(loss_fns, loss_weights, outputs, batch):
    """Weighted sum over the heads the model produced."""
    heads = [h for h in ("seg", "bound", "dist", "color") if h in outputs]
    per_head = {h: loss_fns[h](batch[h], outputs[h]) for h in heads}
    total = sum(per_head[h] * loss_weights.get(h, 1.0) for h in heads)
    return total, per_head


def _metrics_row(multitasking, total, per_head, seg_pred, seg_true,
                 group=None):
    """The row; over a group, one all-reduce: the means (losses, accuracy)
    averaged, the last four entries (the counts) summed."""
    acc = categorical_accuracy(seg_true, seg_pred)
    tp, fp, tn, fn = binary_counts(seg_true, seg_pred)
    if multitasking:
        zero = torch.zeros((), dtype=total.dtype, device=total.device)
        vals = [total, per_head["seg"], per_head["bound"], per_head["dist"],
                per_head.get("color", zero), acc, tp, fp, tn, fn]
    else:
        vals = [total, acc, tp, fp, tn, fn]
    row = torch.stack([v.detach().float() for v in vals])
    if group is None:
        return row
    row, = axis.all_reduce_flat([row], group, mean=False)
    return torch.cat([row[:-4] / group.size, row[-4:]])


@torch.no_grad()
def _pmean_grads(params, group):
    """Each gradient replaced by its mean over the group's ranks, through
    one flat all-reduce (a parameter without a gradient keeps none: the
    graph, and so that set, is the same on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    for g, m in zip(grads, axis.all_reduce_flat(grads, group, mean=True)):
        g.copy_(m)


def _losses(loss_fns, loss_weights, multitasking, outputs, batch):
    if multitasking:
        return _multitask_total(loss_fns, loss_weights, outputs, batch)
    return loss_fns["seg"](batch["seg"], outputs), None


def _on(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _space_sharded(group):
    return getattr(group, "n_space", 1) > 1


def _model_batch(batch, preprocess, dev, group):
    """The model's batch of this rank: `preprocess` of the raw batch (or
    the batch as it is, on dev). Over a space axis the raw bands of 2 or
    more dimensions are gathered into whole planes first, and the band of
    every head kept after."""
    if preprocess is None:
        return _on(batch, dev)
    if not _space_sharded(group):
        return preprocess(batch)
    whole = {k: axis.gather_space(torch.as_tensor(v), dim=1)
             if v.ndim >= 2 else v for k, v in batch.items()}
    return {k: axis.band(v, dim=1) if v.dim() >= 3 else v
            for k, v in preprocess(whole).items()}


def make_train_step(loss_fns: Dict, loss_weights: Dict, multitasking: bool,
                    preprocess=None, device=None, group=None,
                    remat: bool = False):
    """Returns train_step(state, batch) -> (state, metrics_row).

    batch: 'image' plus the label heads ('seg' [+ 'bound', 'dist',
    'color']), or the raw uint8 batch that `preprocess`
    (data.pipeline.make_device_pipeline) turns into one on the device. The
    step runs the model in train mode (batch statistics, running buffers
    updated in place), backpropagates the weighted total, applies the
    optimizer and returns the row of the forward's metrics. The parameters'
    gradients (over a group: their mean over the ranks) stay in `.grad`
    until the next step. With `group`, `batch` is this rank's rows of the
    global batch (parallel.mesh.shard_batch), over a SpaceMesh its rows and
    band (parallel.mesh.shard_batch_spatial). `remat` rematerialises the
    forward's blocks under SAVE_CONVS (module doc)."""
    dev = resolve_device(device)

    def train_step(state, batch):
        with axis.data_axis(group), convseg.disabled(_space_sharded(group)):
            batch = _model_batch(batch, preprocess, dev, group)
            model = state.model
            model.train()
            with remat_scope(SAVE_CONVS) if remat else \
                    contextlib.nullcontext():
                outputs = model(batch["image"])
            total, per_head = _losses(loss_fns, loss_weights, multitasking,
                                      outputs, batch)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            _pmean_grads(model.parameters(), group)
            state.optimizer.step()
            state.step += 1
            seg_pred = outputs["seg"] if multitasking else outputs
            return state, _metrics_row(multitasking, total, per_head,
                                       seg_pred.detach(), batch["seg"],
                                       group)

    return train_step


def make_eval_step(loss_fns: Dict, loss_weights: Dict, multitasking: bool,
                   preprocess=None, device=None, group=None):
    """test_on_batch: eval mode (running statistics), no gradients; `group`
    (a DataGroup or a SpaceMesh) as in make_train_step (the Tanimoto
    volumes and the row reduce over the ranks)."""
    dev = resolve_device(device)

    def eval_step(state, batch):
        with axis.data_axis(group), torch.no_grad(), \
                convseg.disabled(_space_sharded(group)):
            batch = _model_batch(batch, preprocess, dev, group)
            model = state.model
            model.eval()
            outputs = model(batch["image"])
            total, per_head = _losses(loss_fns, loss_weights, multitasking,
                                      outputs, batch)
            seg_pred = outputs["seg"] if multitasking else outputs
            return _metrics_row(multitasking, total, per_head, seg_pred,
                                batch["seg"], group)

    return eval_step
