"""Ranks of the port's data-parallel CPU tests (tests/test_torch_dist*.py);
not a test module. It imports no JAX: the spawned ranks import it.

`run_ranks(fn, tmp_path, *args)` starts two gloo ranks on the CPU, one
torch thread each, joined through a file:// rendezvous under tmp_path (no
port, so test workers never collide), each calling fn(group, *args) and
saving what it returns; it returns the ranks' results in rank order. A
rank that fails, or a run past its timeout, raises.
"""

import os
import sys
from pathlib import Path

import torch

from resuneta_torch.parallel import (destroy_group, init_group, launch,
                                     shard_batch)

TIMEOUT_S = 120


def _rank(rank, fn, nprocs, init_method, out_dir, args):
    torch.set_num_threads(1)
    group = init_group("gloo", "cpu", rank=rank, world_size=nprocs,
                       init_method=init_method, timeout_s=TIMEOUT_S)
    try:
        out = fn(group, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy_group(group)


def run_ranks(fn, tmp_path, *args, nprocs=2, timeout_s=TIMEOUT_S):
    out = Path(tmp_path) / f"ranks_{fn.__name__}"
    out.mkdir(parents=True)
    launch.spawn(_rank, nprocs, (fn, nprocs, launch.rendezvous(str(out)),
                                 str(out), args), timeout_s=timeout_s)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(nprocs)]


# ------------------------------------------------------------ rank bodies

def collectives(group, xs, wants_grad):
    """pmean/psum of this rank's rows, bn_stats and tanimoto_dual_loss on
    its rows of the global batch, and the gradients of each rank's share
    (1/R) of a loss of them: the shares sum to that loss of the global
    batch, so each rank's gradients are one process's on its rows."""
    from resuneta_torch import losses
    from resuneta_torch.ops.fused_bn import bn_stats
    from resuneta_torch.parallel import axis

    out = {}
    x = torch.tensor(shard_batch(xs["x"], group), requires_grad=True)
    with axis.data_axis(group):
        m, s = axis.pmean((x.sum(0), (x * x).sum(0)))
        t = axis.psum(x.sum())
    (((m * torch.arange(m.numel())).sum() + s.sum() + 3 * t) /
     group.size).backward()
    out["pmean"], out["psum"] = m.detach(), t.detach()
    out["pmean_grad"] = x.grad

    h = torch.tensor(shard_batch(xs["h"], group), requires_grad=True)
    with axis.data_axis(group):
        mean, var = bn_stats(h)
    ((mean * torch.from_numpy(wants_grad["mean"]) +
      var * torch.from_numpy(wants_grad["var"])).sum() /
     group.size).backward()
    out["bn"] = (mean.detach(), var.detach(), h.grad)

    label = torch.tensor(shard_batch(xs["label"], group))
    pred = torch.tensor(shard_batch(xs["pred"], group), requires_grad=True)
    with axis.data_axis(group):
        loss = losses.tanimoto_dual_loss(label, pred)
    (loss / group.size).backward()
    out["tanimoto"] = (loss.detach(), pred.grad)
    return out


def kernel_counts():
    """The call counts of the kernels' wrappers on the train step's path
    (the plain versions on the CPU): K1, K2, K5, K6."""
    from resuneta_torch.ops import boundary, convseg, distance

    return [convseg.CALLS, convseg.BWD_CALLS, distance.CALLS,
            boundary.CALLS]


def multitask_step(group, weights_path, raw, lr, nc=5, remat=False):
    """One SGD train step of the 64 px multitask ResUnet-a d6 (Tanimoto on
    the four heads, make_device_pipeline) from the weights at
    `weights_path`, on this rank's rows of the raw batch (all of it without
    a group), rematerialised with `remat`; then the eval row of the
    stepped state on the same rows. Returns the rows, the state_dict after
    the step and the kernel calls of the train step."""
    from resuneta_torch import losses
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.models import ResUnetA
    from resuneta_torch.train import (create_train_state, make_eval_step,
                                      make_train_step)

    ps = raw["image_u8"].shape[1]
    model = ResUnetA(nc, img_size=ps, multitasking=True, device="cpu")
    model.load_state_dict(torch.load(weights_path, weights_only=True))
    state = create_train_state(model, "sgd", lr)
    heads = {h: 1.0 for h in ("seg", "bound", "dist", "color")}
    pipe = make_device_pipeline(nc, 1, device="cpu")
    local = shard_batch(raw, group)
    step = make_train_step(losses.make_losses("tanimoto"), heads, True,
                           preprocess=pipe, device="cpu", group=group,
                           remat=remat)
    before = kernel_counts()
    state, row = step(state, local)
    counts = [a - b for a, b in zip(kernel_counts(), before)]
    evaluate = make_eval_step(losses.make_losses("tanimoto"), heads, True,
                              preprocess=pipe, device="cpu", group=group)
    return {"row": row.numpy(), "eval_row": evaluate(state, local).numpy(),
            "state_dict": {k: v.clone() for k, v in
                           model.state_dict().items()},
            "counts": counts, "step": state.step}


def train_loop(group, root, results, epochs, batch_size, lr, nc=3):
    """train_model of a tiny UNet (SGD, cross entropy) on the packed set
    at `root`, on this rank's rows, into results[rank]; then a fresh state
    restored from rank 0's best checkpoint (lr halved) trains one more
    epoch into results[rank] + "_resume". Every rank starts from its own
    seeded init, and replicate_state gives it rank 0's. Returns the
    histories, stdout, the trained state_dict and the resumed state's step
    and learning rate."""
    import contextlib
    import io
    from dataclasses import replace

    import numpy as np

    from resuneta_torch import losses
    from resuneta_torch.data import PackedDataset, make_device_pipeline
    from resuneta_torch.data.split import train_test_split
    from resuneta_torch.models import UNet
    from resuneta_torch.parallel import replicate_state
    from resuneta_torch.train import (TrainConfig, checkpoint,
                                      create_train_state, make_eval_step,
                                      make_train_step, train_model)

    rank = 0 if group is None else group.rank

    def fresh(seed):
        model = UNet(nc, base_filters=4, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
        return create_train_state(model, "sgd", lr)

    full = PackedDataset(root)
    tr, va = train_test_split(np.arange(len(full)), test_size=0.2,
                              random_state=42)
    loss = losses.make_losses("cross_entropy")
    pipe = make_device_pipeline(nc, 1, False, device="cpu")
    tstep = make_train_step(loss, {}, False, preprocess=pipe, device="cpu",
                            group=group)
    estep = make_eval_step(loss, {}, False, preprocess=pipe, device="cpu",
                           group=group)
    cfg = TrainConfig(results_path=results[rank], batch_size=batch_size,
                      epochs=epochs, multitasking=False, seed=5)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = replicate_state(fresh(1 + rank), group)
        state, hist = train_model(cfg, state, tstep, estep, full.subset(tr),
                                  full.subset(va), group=group)
        trained = {k: v.clone() for k, v in state.model.state_dict().items()}
        resumed, meta = checkpoint.restore(
            os.path.join(results[0], cfg.checkpoint_name), fresh(9),
            learning_rate_override=lr / 2, group=group)
        resumed = replicate_state(resumed, group)
        resumed, hist2 = train_model(
            replace(cfg, results_path=results[rank] + "_resume", epochs=1),
            resumed, tstep, estep, full.subset(tr), full.subset(va),
            group=group)
    return {"history": hist, "resume_history": hist2, "stdout":
            out.getvalue(), "trained": trained, "meta": meta,
            "resume_step": resumed.step, "resume_lr": resumed.learning_rate}


def torchrun_rank(rank, module, argv, env, out_dir):
    """A CLI's main as one torchrun-style rank: WORLD_SIZE, RANK,
    LOCAL_RANK and the rendezvous's MASTER_ADDR/MASTER_PORT in the
    environment, as torchrun sets them. Saves its history and stdout."""
    import contextlib
    import importlib
    import io

    torch.set_num_threads(1)
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, history = importlib.import_module(module).main(argv)
    torch.save({"history": history, "stdout": out.getvalue()},
               os.path.join(out_dir, f"rank{rank}.pt"))


def sharded_patches(group, patches, batch_size, scene, stride, step_args):
    """predict_patches and predict_scene_overlap of a small seeded UNet,
    sharded over the group, and unsharded at the per-rank batch (the same
    forward batches); then multitask_step(*step_args) over the group
    without and with remat."""
    from resuneta_torch.infer.sliding import (make_apply_fn,
                                              predict_patches,
                                              predict_scene_overlap,
                                              seg_ids_u8)
    from resuneta_torch.models import UNet

    model = UNet(num_classes=3, in_channels=patches.shape[-1],
                 generator=torch.Generator().manual_seed(5), device="cpu")
    fn = make_apply_fn(model, "cpu")
    sharded = predict_patches(fn, patches, batch_size, device_post=seg_ids_u8,
                              group=group)
    alone = predict_patches(fn, patches, batch_size // group.size,
                            device_post=seg_ids_u8)
    probs = predict_patches(fn, patches, batch_size, group=group)
    p = patches.shape[1]
    overlap = predict_scene_overlap(fn, scene, p, stride, batch_size,
                                    multitask=False, group=group)
    overlap_alone = predict_scene_overlap(fn, scene, p, stride,
                                          batch_size // group.size,
                                          multitask=False)
    steps = {remat: multitask_step(group, *step_args, remat=remat)
             for remat in (False, True)}
    return {"sharded": sharded, "alone": alone, "probs": probs,
            "overlap": overlap, "overlap_alone": overlap_alone,
            "steps": steps}


def barrier_then_wait(group, rank_late, delay_s, timeout_s):
    """A barrier that rank `rank_late` reaches delay_s late; returns
    whether it raised, and its message."""
    import time

    from resuneta_torch.parallel import multihost

    if group.rank == rank_late:
        time.sleep(delay_s)
    try:
        multihost.barrier(group, "test barrier", timeout_s=timeout_s)
        return None
    except RuntimeError as e:
        return str(e)


def fails_on_rank_1(group):
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return group.rank


if __name__ == "__main__":
    sys.exit("this module holds the ranks of tests/test_torch_dist*.py")
