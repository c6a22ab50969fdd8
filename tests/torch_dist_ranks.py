"""Ranks of the port's distributed CPU tests (tests/test_torch_dist*.py,
tests/test_torch_space.py); not a test module. It imports no JAX: the
spawned ranks import it.

`run_ranks(fn, tmp_path, *args)` starts two (`nprocs`) gloo ranks on the
CPU, one torch thread each, joined through a file:// rendezvous under
tmp_path (no port, so test workers never collide), each calling fn(group,
*args) and saving what it returns (with `mesh=(n_data, n_space)` the group
is make_mesh_2d's SpaceMesh); it returns the ranks' results in rank
order. A rank that fails, or a run past its timeout, raises.
"""

import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from resuneta_torch.parallel import (DataGroup, SpaceMesh, destroy_group,
                                     init_group, launch, make_mesh_2d,
                                     multihost, shard_batch)

TIMEOUT_S = 120


def _rank(rank, fn, nprocs, init_method, out_dir, args, mesh):
    torch.set_num_threads(1)
    kw = dict(rank=rank, world_size=nprocs, init_method=init_method,
              timeout_s=TIMEOUT_S)
    group = make_mesh_2d(*mesh, "gloo", "cpu", **kw) if mesh else \
        init_group("gloo", "cpu", **kw)
    try:
        out = fn(group, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy_group(group)


def run_ranks(fn, tmp_path, *args, nprocs=2, timeout_s=TIMEOUT_S,
              mesh=None):
    out = Path(tmp_path) / f"ranks_{fn.__name__}"
    out.mkdir(parents=True)
    launch.spawn(_rank, nprocs, (fn, nprocs, launch.rendezvous(str(out)),
                                 str(out), args, mesh), timeout_s=timeout_s)
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


# ------------------------------------------------ the space axis (4 ranks)

def halo_case(mesh, planes, weights, rows):
    """halo(band, d) for d in `rows` over the mesh's space axis, on this
    rank's rows and band of `planes` (N, C, H, W): the outputs, and the
    band's gradient of sum(halo(band, d) * weights[rows, :, space index])
    summed over d."""
    from resuneta_torch.parallel import axis

    lo, hi = multihost.host_batch_slice(len(planes), mesh.n_data,
                                        mesh.data.rank)
    h = planes.shape[2] // mesh.n_space
    j = mesh.space.rank
    x = torch.tensor(planes[lo:hi, :, j * h:(j + 1) * h], requires_grad=True)
    outs = {}
    with axis.data_axis(mesh):
        for d in rows:
            y = axis.halo(x, d)
            (y * torch.from_numpy(weights[d][lo:hi, :, j])).sum().backward()
            outs[d] = y.detach()
    return {"rows": (lo, hi), "band": (j * h, (j + 1) * h), "halo": outs,
            "grad": x.grad}


def space_step(mesh, weights_path, raw, lr, remat=False, nc=5):
    """One SGD step of the 64 px multitask ResUnet-a d6 over the mesh (the
    pipeline on whole planes, Tanimoto on four heads), remat or not, then
    the eval row, on this rank's rows and band of `raw`; the kernel calls
    (K1, K2, K5, K6, K3, K4) of the train step."""
    from resuneta_torch import losses
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.models import ResUnetA
    from resuneta_torch.ops import densemm, poolconv
    from resuneta_torch.parallel import shard_batch_spatial
    from resuneta_torch.train import (create_train_state, make_eval_step,
                                      make_train_step)

    ps = raw["image_u8"].shape[1]
    model = ResUnetA(nc, img_size=ps, multitasking=True, device="cpu")
    model.load_state_dict(torch.load(weights_path, weights_only=True))
    state = create_train_state(model, "sgd", lr)
    heads = {h: 1.0 for h in ("seg", "bound", "dist", "color")}
    pipe = make_device_pipeline(nc, 1, device="cpu")
    local = shard_batch_spatial(raw, mesh)
    args = (losses.make_losses("tanimoto"), heads, True)
    step = make_train_step(*args, preprocess=pipe, device="cpu", group=mesh,
                           remat=remat)

    def counts():
        return kernel_counts() + [densemm.CALLS, poolconv.CALLS]

    before = counts()
    state, row = step(state, local)
    calls = [a - b for a, b in zip(counts(), before)]
    evaluate = make_eval_step(*args, preprocess=pipe, device="cpu",
                              group=mesh)
    return {"row": row.numpy(), "eval_row": evaluate(state, local).numpy(),
            "state_dict": {k: v.clone() for k, v in
                           model.state_dict().items()},
            "counts": calls, "local_shape": local["image_u8"].shape}


def unet_step(mesh, weights_path, batch, lr):
    """One SGD step of UNet(3, 8 filters) with cross entropy over the mesh
    on this rank's rows and band of the float `batch`."""
    from resuneta_torch import losses
    from resuneta_torch.models import UNet
    from resuneta_torch.parallel import shard_batch_spatial
    from resuneta_torch.train import create_train_state, make_train_step

    model = UNet(3, base_filters=8, device="cpu")
    model.load_state_dict(torch.load(weights_path, weights_only=True))
    state = create_train_state(model, "sgd", lr)
    step = make_train_step(losses.make_losses("cross_entropy"), {}, False,
                           device="cpu", group=mesh)
    state, row = step(state, shard_batch_spatial(batch, mesh))
    return {"row": row.numpy(), "state_dict": {
        k: v.clone() for k, v in model.state_dict().items()}}


def space_patches(mesh, weights_path, patches, batch_size):
    """predict_patches of UNet(3, 8 filters) over the mesh, and at each
    forward whether the kernels were off (convseg.disabled) and its rows."""
    from resuneta_torch.infer.sliding import make_apply_fn, predict_patches
    from resuneta_torch.models import UNet
    from resuneta_torch.ops import convseg

    model = UNet(3, base_filters=8, device="cpu")
    model.load_state_dict(torch.load(weights_path, weights_only=True))
    fn, off = make_apply_fn(model, "cpu"), []

    def apply_fn(x):
        off.append((convseg.is_disabled(), len(x)))
        return fn(x)

    return {"out": predict_patches(apply_fn, patches, batch_size,
                                   group=mesh), "forwards": off}


def sub_mesh(world, grid):
    """The SpaceMesh over the world's ranks `grid` (n_data lists of n_space
    global ranks, each list one data index's bands), its groups from
    dist.new_group as make_mesh_2d makes its axes; None on a rank outside
    it. Every rank of the world calls this with the same grid."""
    def group(ranks):
        pg = dist.new_group(list(ranks))
        if world.rank not in ranks:
            return None
        return DataGroup(pg, pg, ranks.index(world.rank), len(ranks),
                         world.device, world.backend, tuple(ranks))

    whole = group(tuple(r for row in grid for r in row))
    space = [group(tuple(row)) for row in grid]
    data = [group(col) for col in zip(*grid)]
    if whole is None:
        return None
    i = next(i for i, row in enumerate(grid) if world.rank in row)
    return SpaceMesh(whole, data[grid[i].index(world.rank)], space[i],
                     len(grid), len(grid[0]))


def space_cases(m22, planes, halo_weights, rows, unet_args, step_args,
                patch_args):
    """The space-axis cases on 4 ranks: make_mesh_2d's 2 x 2 mesh, and
    sub-meshes of its world 1 x 4 and 1 x 2 over ranks {0, 1} and {2, 3}.
    The halo over 2 and 4 bands; UNet's step and predict_patches over
    2 x 2; the ResUnet-a step over 1 x 2 (ranks 0, 1 plain, ranks 2, 3 with
    remat)."""
    world = m22.world
    m14 = sub_mesh(world, [[0, 1, 2, 3]])
    m12 = [sub_mesh(world, grid) for grid in ([[0, 1]], [[2, 3]])]
    m12 = m12[0] or m12[1]
    return {
        "halo_2": halo_case(m22, planes, halo_weights[2], rows),
        "halo_4": halo_case(m14, planes, halo_weights[4], rows),
        "unet": unet_step(m22, *unet_args),
        "patches": space_patches(m22, *patch_args),
        "resuneta": space_step(m12, *step_args, remat=world.rank >= 2),
        "coords": (m22.data.rank, m22.space.rank)}


def card_halo(rank, init_method, out_dir, planes, rows):
    """A rank of the card test: two gloo ranks share cuda:0 as a 1 x 2
    mesh; for each d in `rows` the halo of this rank's band of `planes` on
    the card, and the band's gradient of the halos' sums of squares.
    Saves them to out_dir/rank<r>.pt."""
    from resuneta_torch.parallel import axis, make_mesh_2d

    mesh = make_mesh_2d(1, 2, "gloo", "cuda:0", rank=rank, world_size=2,
                        init_method=init_method, gloo_on_cuda=True,
                        timeout_s=TIMEOUT_S)
    try:
        h = planes.shape[2] // 2
        x = torch.tensor(planes[:, :, rank * h:(rank + 1) * h],
                         device="cuda", requires_grad=True)
        outs = {}
        with axis.data_axis(mesh):
            for d in rows:
                y = axis.halo(x, d)
                (y * y).sum().backward()
                outs[d] = y.detach().cpu()
        torch.save({"halo": outs, "grad": x.grad.cpu()},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy_group(mesh)


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
