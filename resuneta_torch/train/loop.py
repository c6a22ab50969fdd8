"""Epoch training loop (resuneta_tpu/train/loop.py), the train_model
equivalent (train_ISPRS.py:55-293): per-epoch shuffle, batched train/eval
steps, per-task epoch report, TensorBoard scalars with the reference's exact
tag layout, MCC, early stopping (patience 10, delta 1e-3 with the
reference's `val_loss >= min_loss + delta` tie-penalizing comparison) and
best-model checkpointing.

The loop is host-side orchestration only: the steps (train/steps.py) run on
their device, and their metric rows stay device tensors until the epoch
ends, so the host never waits on the device inside an epoch.

Data parallelism (`group=`, the reference's `mesh`, loop.py:71-130): every
rank draws the same permutation and loads only its rows of each global
batch of config.batch_size (which R must divide), through the steps built
with the same group. Their rows are already reduced over the ranks, so
every rank reads the same metrics and early stopping decides alike; rank 0
alone prints, writes TensorBoard, profiles and saves, and the ranks meet at
a barrier once its saves are on disk.
"""

import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..metrics import compute_mcc
from ..parallel import multihost
from ..parallel.mesh import shard_batch
from ..utils.table import ascii_table
from .checkpoint import AsyncSaver, save_best
from .steps import METRICS_MULTITASK, METRICS_SINGLE


@dataclass
class TrainConfig:
    results_path: str = "./results/results_run1"
    batch_size: int = 4
    epochs: int = 500
    multitasking: bool = True
    patience: int = 10
    delta: float = 1e-3
    seed: int = 0
    tensorboard: bool = True
    verbose: bool = True
    checkpoint_name: str = "best_model.ckpt"
    profile_dir: Optional[str] = None  # torch.profiler trace of epoch 0
    async_checkpoint: bool = True      # checkpoints written off the loop
    keep_last: int = 0                 # also keep the last N epoch checkpoints


def _writers(config):
    if not config.tensorboard:
        return None, None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None, None
    return (
        SummaryWriter(os.path.join(config.results_path, "logs", "train")),
        SummaryWriter(os.path.join(config.results_path, "logs", "val")),
    )


def _add_scalars(train_w, val_w, epoch, name, train_loss, val_loss,
                 train_acc=None, val_acc=None, val_mcc=None):
    """Tag layout of add_tensorboard_scalars (train_ISPRS.py:35-53)."""
    if train_w is None:
        return
    train_w.add_scalar(name + "/Loss", float(train_loss), epoch)
    if train_acc is not None:
        train_w.add_scalar(name + "/Accuracy", float(train_acc), epoch)
    val_w.add_scalar(name + "/Loss", float(val_loss), epoch)
    if val_acc is not None:
        val_w.add_scalar(name + "/Accuracy", float(val_acc), epoch)
    if val_mcc is not None:
        val_w.add_scalar(name + "/MCC", float(val_mcc), epoch)


def epoch_batches(n, batch_size, ranks=1):
    """(batches, batch size) of an epoch pass over n samples: the whole
    batches, or one short batch where n is under one batch (rather than
    silently skipping the split), cut to a multiple of the ranks; raises
    where n is under the ranks, which cannot share a batch."""
    if n // batch_size == 0 and n > 0:
        if n < ranks:
            raise ValueError(f"{n} samples cannot make a batch for {ranks} "
                             "ranks")
        return 1, n // ranks * ranks
    return n // batch_size, batch_size


def _epoch_pass(step_fn, state, ds, batch_size, order, train: bool,
                group=None):
    rows = []
    n_batches, batch_size = epoch_batches(
        len(ds), batch_size, 1 if group is None else group.size)
    for b in range(n_batches):
        # this rank's rows of the global batch
        pos = shard_batch(order[b * batch_size:(b + 1) * batch_size], group)
        raw = ds.get_batch(pos)
        if train:
            state, row = step_fn(state, raw)
        else:
            row = step_fn(state, raw)
        rows.append(row)  # device tensors; the sync waits for the epoch end
    mean = np.mean(torch.stack([torch.as_tensor(r) for r in rows])
                   .cpu().numpy(), axis=0) if rows else np.zeros(0)
    return state, mean


def train_model(config: TrainConfig, state, train_step, eval_step,
                train_ds, val_ds, group=None):
    """Returns (state, history list of per-epoch dicts). Saves the best checkpoint
    under config.results_path like the reference saves best_model.h5.
    With `group` (a parallel.mesh.DataGroup; train_step and eval_step built
    with it) every rank calls this and trains its shard of each batch."""
    names = METRICS_MULTITASK if config.multitasking else METRICS_SINGLE
    if getattr(group, "n_space", 1) > 1:
        raise ValueError("train_model shards rows only: drive a space-"
                         "sharded step (a SpaceMesh) with its own batches "
                         "(parallel.mesh.shard_batch_spatial)")
    if group is not None and config.batch_size % group.size:
        raise ValueError(f"batch size {config.batch_size} does not divide "
                         f"over {group.size} ranks")
    lead = multihost.is_coordinator(group)
    if not lead:
        # rank 0 alone prints, writes TensorBoard, profiles and saves
        config = replace(config, verbose=False, tensorboard=False,
                         profile_dir=None, async_checkpoint=False,
                         keep_last=0)
    train_w, val_w = _writers(config)
    if lead:
        os.makedirs(config.results_path, exist_ok=True)
    ckpt_path = os.path.join(config.results_path, config.checkpoint_name) \
        if lead else None

    if config.verbose:
        print("Start training...")
        print("=" * 60)
        print(f"Training on {len(train_ds)} images")
        print(f"Validating on {len(val_ds)} images")
        print("=" * 60)
        print(f"Total Epochs: {config.epochs}")

    rng = np.random.default_rng(config.seed)
    history = []
    saver = AsyncSaver(keep_last=config.keep_last) \
        if (config.async_checkpoint or config.keep_last) else None

    # Always drain pending async saves: an exception or KeyboardInterrupt
    # mid-epoch must not abandon a checkpoint still being written (its meta
    # JSON follows only once the checkpoint is on disk, see AsyncSaver).
    try:
        out = _train_epochs(config, state, train_step, eval_step, train_ds,
                            val_ds, names, train_w, val_w, saver, rng,
                            history, ckpt_path, group)
    finally:
        if saver is not None:
            saver.close()
        for w in (train_w, val_w):
            if w is not None:
                w.close()
    # rank 0's checkpoints are on disk: any rank may read them now
    multihost.barrier(group, "train_model end")
    return out


def _profile_start():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _profile_stop(prof, config):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(config.profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(config.profile_dir,
                                          "epoch_0.trace.json"))


def _train_epochs(config, state, train_step, eval_step, train_ds, val_ds,
                  names, train_w, val_w, saver, rng, history, ckpt_path,
                  group):
    ranks = 1 if group is None else group.size
    min_loss = float("inf")
    cont = 0
    for epoch in range(config.epochs):
        t0 = time.time()
        perm = rng.permutation(len(train_ds))
        prof = _profile_start() \
            if config.profile_dir is not None and epoch == 0 else None
        state, loss_tr = _epoch_pass(
            train_step, state, train_ds, config.batch_size, perm, train=True,
            group=group)
        if prof is not None:
            _profile_stop(prof, config)
        train_time = time.time() - t0
        # the samples the pass ran: whole batches, or the one short batch
        n_batches, n_per = epoch_batches(len(train_ds), config.batch_size,
                                         ranks)
        n_seen = n_batches * n_per
        order_val = np.arange(len(val_ds))
        _, loss_val = _epoch_pass(
            eval_step, state, val_ds, config.batch_size, order_val,
            train=False, group=group)

        train_metrics = dict(zip(names, loss_tr.tolist()))
        val_metrics = dict(zip(names, loss_val.tolist()))
        patches_per_sec = n_seen / max(train_time, 1e-9)
        history.append({"train": train_metrics, "val": val_metrics,
                        "time": time.time() - t0,
                        "patches_per_sec": patches_per_sec})
        if train_w is not None:
            train_w.add_scalar("Perf/patches_per_sec", patches_per_sec, epoch)

        if not config.multitasking:
            mcc = float(compute_mcc(
                val_metrics["true_positives"], val_metrics["true_negatives"],
                val_metrics["false_positives"], val_metrics["false_negatives"]))
            if config.verbose:
                print(f"Epoch: {epoch} "
                      f"Training loss: {train_metrics['loss']:.5f} "
                      f"Train acc.: {100 * train_metrics['accuracy']:.5f}% "
                      f"Validation loss: {val_metrics['loss']:.5f} "
                      f"Validation acc.: {100 * val_metrics['accuracy']:.5f}%")
            _add_scalars(train_w, val_w, epoch, "Total",
                         train_metrics["loss"], val_metrics["loss"],
                         train_metrics["accuracy"], val_metrics["accuracy"], mcc)
            val_loss = val_metrics["loss"]
        else:
            mcc = float(compute_mcc(
                val_metrics["seg_true_positives"], val_metrics["seg_true_negatives"],
                val_metrics["seg_false_positives"], val_metrics["seg_false_negatives"]))
            rows = [
                ["Seg", round(train_metrics["seg_loss"], 5),
                 round(val_metrics["seg_loss"], 5),
                 round(100 * train_metrics["seg_accuracy"], 5),
                 round(100 * val_metrics["seg_accuracy"], 5)],
                ["Bound", round(train_metrics["bound_loss"], 5),
                 round(val_metrics["bound_loss"], 5), 0, 0],
                ["Dist", round(train_metrics["dist_loss"], 5),
                 round(val_metrics["dist_loss"], 5), 0, 0],
                ["Color", round(train_metrics["color_loss"], 5),
                 round(val_metrics["color_loss"], 5), 0, 0],
                ["Total", round(train_metrics["loss"], 5),
                 round(val_metrics["loss"], 5), 0, 0],
            ]
            _add_scalars(train_w, val_w, epoch, "Segmentation",
                         train_metrics["seg_loss"], val_metrics["seg_loss"],
                         train_metrics["seg_accuracy"], val_metrics["seg_accuracy"], mcc)
            _add_scalars(train_w, val_w, epoch, "Boundary",
                         train_metrics["bound_loss"], val_metrics["bound_loss"])
            _add_scalars(train_w, val_w, epoch, "Distance",
                         train_metrics["dist_loss"], val_metrics["dist_loss"])
            _add_scalars(train_w, val_w, epoch, "Color",
                         train_metrics["color_loss"], val_metrics["color_loss"])
            _add_scalars(train_w, val_w, epoch, "Total",
                         train_metrics["loss"], val_metrics["loss"])
            if config.verbose:
                print(ascii_table(f"Epoch: {epoch}",
                                  ["Task", "Loss", "Val Loss", "Acc %", "Val Acc %"],
                                  rows))
            val_loss = val_metrics["loss"]

        # Early stopping with the reference's exact comparison (train_ISPRS.py:280)
        if val_loss >= min_loss + config.delta:
            cont += 1
            if config.verbose:
                print(f"EarlyStopping counter: {cont} out of {config.patience}")
            if cont >= config.patience:
                if config.verbose:
                    print("Early Stopping! \t Training Stopped")
                return state, history
        else:
            cont = 0
            min_loss = val_loss
            if config.verbose:
                print("Saving best model...")
            if saver is not None:
                saver.save_best(ckpt_path, state, epoch, min_loss)
            elif ckpt_path is not None:
                save_best(ckpt_path, state, epoch, min_loss)
        if saver is not None and config.keep_last:
            saver.save_epoch(os.path.join(config.results_path, "checkpoints"),
                             state, epoch)

    return state, history
