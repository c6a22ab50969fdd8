"""Checkpoints: the best-model policy, resume with a learning-rate override
(resuneta_tpu/train/checkpoint.py; the reference's best_model.h5 save,
train_ISPRS.py:291-292, and its load_model + K.set_value(lr) resume,
train_ISPRS.py:471-480), and model weights alone.

A training checkpoint is a directory holding one file, `checkpoint.pt`,
written with torch.save: {"model": the model's state_dict (parameters and
the BN running buffers), "optimizer": the optimizer's state_dict (its
moments, step counts and learning rate), "step": the train step count},
every tensor on the CPU. The paths are the JAX package's layout:
`<results>/best_model.ckpt/` (this directory), its
`<results>/best_model.ckpt.meta.json` {"epoch", "min_val_loss"}, and
`<results>/checkpoints/epoch_<n>/` for the keep-last policy. `restore`
reads these only; an orbax checkpoint of the JAX package is read by
flattening its variables to an .npz (tools/flax_ckpt_to_npz.py) and
loading that with `restore_variables`.

`AsyncSaver` copies the payload to the CPU before it returns and writes on
one background thread, each file under a temporary name and then
`os.replace`, so the training goes on while the file is written and a
crash leaves the old checkpoint or the new one, never half of one.

Across data-parallel ranks the coordinator (rank 0) alone saves, and its
AsyncSaver runs there only (train/loop.py); `restore` runs on every rank,
each after a barrier, so no rank reads a checkpoint before rank 0's saves
are on disk.
"""

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..convert import from_flax
from ..parallel.multihost import barrier

CKPT_FILE = "checkpoint.pt"


def _abs(path):
    return os.path.abspath(str(path))


def _to_cpu(obj):
    """A copy of a (nested) state_dict with every tensor copied to the CPU,
    so later steps cannot change what is saved."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _payload(state):
    return {"model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "step": int(state.step)}


def _replace_write(path, write):
    """write(tmp) then os.replace(tmp, path): the file is whole or absent."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_ckpt(ckpt_dir, payload):
    os.makedirs(ckpt_dir, exist_ok=True)
    _replace_write(os.path.join(ckpt_dir, CKPT_FILE),
                   lambda tmp: torch.save(payload, tmp))


def _write_meta(ckpt_dir, epoch, min_loss):
    meta = {"epoch": epoch, "min_val_loss": float(min_loss)}

    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _replace_write(ckpt_dir + ".meta.json", write)


def _write_best(ckpt_dir, payload, epoch, min_loss):
    """The checkpoint, then its meta: the meta never names a checkpoint
    that is not on disk."""
    _write_ckpt(ckpt_dir, payload)
    _write_meta(ckpt_dir, epoch, min_loss)


def save_best(ckpt_dir, state, epoch: int, min_loss: float):
    """Overwrite the single best checkpoint (save_best_only semantics)."""
    _write_best(_abs(ckpt_dir), _payload(state), epoch, min_loss)


def _write_epoch(root_dir, payload, epoch, keep_last):
    """`<root_dir>/epoch_<epoch>`, then prune to the newest `keep_last`
    completed epochs (0: keep all)."""
    _write_ckpt(os.path.join(root_dir, f"epoch_{epoch}"), payload)
    if not keep_last:
        return
    done = sorted(
        (int(d.split("_")[1]), d) for d in os.listdir(root_dir)
        if d.startswith("epoch_") and d.split("_")[1].isdigit()
        and os.path.exists(os.path.join(root_dir, d, CKPT_FILE)))
    for _, d in done[:-keep_last]:
        shutil.rmtree(os.path.join(root_dir, d), ignore_errors=True)


class AsyncSaver:
    """Non-blocking checkpointing with best-model + keep-last-N policies.

    save_best(...) does what save_best() above does, but returns once the
    payload is copied to the CPU; one background thread writes it, then
    its meta JSON. save_epoch(...) writes `<dir>/epoch_<n>` and then prunes
    to the newest `keep_last` completed epochs. The writes run in the order
    they were asked for. wait() drains them and raises a write's error;
    close() (or the context manager) drains and stops the thread.
    """

    def __init__(self, keep_last: int = 0):
        self.keep_last = keep_last
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending = []

    def save_best(self, ckpt_dir, state, epoch: int, min_loss: float):
        self._pending.append(self._pool.submit(
            _write_best, _abs(ckpt_dir), _payload(state), epoch, min_loss))

    def save_epoch(self, root_dir, state, epoch: int):
        self._pending.append(self._pool.submit(
            _write_epoch, _abs(root_dir), _payload(state), epoch,
            self.keep_last))

    def wait(self):
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _ckpt_file(path):
    path = _abs(path)
    if os.path.isfile(path):
        return path
    f = os.path.join(path, CKPT_FILE)
    if os.path.isdir(path) and not os.path.exists(f):
        raise ValueError(
            f"{path} holds no {CKPT_FILE}: it is not a checkpoint of the "
            "port (an orbax checkpoint of the JAX package?). Flatten its "
            "variables with tools/flax_ckpt_to_npz.py and load the .npz "
            "with resuneta_torch.train.checkpoint.restore_variables")
    return f


def restore(ckpt_dir, state, learning_rate_override=None, group=None):
    """Load a checkpoint of the port into an existing TrainState: the
    model's parameters and buffers, the optimizer's state and the step,
    each onto the device its tensor already lives on; then the learning
    rate override, as the reference does on resume. Returns
    (state, meta), meta {} where no meta JSON is beside the checkpoint.
    With `group` every rank calls it, and reads after a barrier."""
    barrier(group, f"restore {ckpt_dir}")
    payload = torch.load(_ckpt_file(ckpt_dir), map_location="cpu",
                         weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if learning_rate_override is not None:
        state = state.override_learning_rate(learning_rate_override)
    meta = {}
    meta_path = _abs(ckpt_dir) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def restore_model(ckpt_dir, model):
    """Load only the model's state_dict of a training checkpoint (the
    directory, or its checkpoint.pt) into `model`, strict; for evaluation,
    which needs no optimizer."""
    payload = torch.load(_ckpt_file(ckpt_dir), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return model


def restore_variables(path, model=None):
    """A state_dict from `path` (.pt, or .npz of Flax variables). With
    `model`, the keys and shapes are checked against it and loaded into it."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as npz:
            sd = from_flax(dict(npz), model)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if model is not None:
        model.load_state_dict(sd, strict=True)
    return sd


def save_variables(path, model):
    """Write model's state_dict (on the CPU) to a `.pt` file."""
    path = str(path)
    if not path.endswith(".pt"):
        raise ValueError(f"save_variables writes .pt files, got {path!r}")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
