"""The data-parallel group and the 2-D (data, space) group
(resuneta_tpu/parallel/mesh.py:37-107): the counterparts of the JAX
package's 1-D 'data' mesh and of its `make_mesh_2d`.

A DataGroup is one process a rank, R ranks, each with its device: the
process group whose collectives carry the step's reductions (NCCL between
cards, gloo between CPU processes), a gloo channel for host-side work
(barriers, the gather of inference outputs), this rank and R. Each rank's
step sees B/R contiguous rows of the global batch of B (`shard_batch`, as
P('data') lays them out), and every rank starts from rank 0's parameters,
buffers and optimizer state (`replicate_state`).

A SpaceMesh (`make_mesh_2d`) lays R = D x S ranks out as the reference's
device grid (rank = data index x S + space index): the world, the data
axis (the D ranks at this space index) and the space axis (the S ranks at
this data index), each a DataGroup of its own. Each rank's step sees B/D
rows and one band of H/S rows of every image (`shard_batch_spatial`, as
P('data', 'space') lays them out); `shard_batch` over a SpaceMesh gives
the rows alone, the space ranks holding the same ones (P('data')).

The backend is always the caller's choice; nothing here switches it.
"""

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import multihost


@dataclass(frozen=True)
class DataGroup:
    pg: object              # the process group of the step's collectives
    host: object            # a gloo group: barriers and host gathers
    rank: int
    size: int
    device: torch.device    # this rank's device
    backend: str
    ranks: tuple = ()       # the global ranks of the group, by its rank


@dataclass(frozen=True)
class SpaceMesh:
    """The 2-D group. Its pg, host, rank, size, device and backend are the
    world's, so a SpaceMesh serves where a DataGroup over every rank does
    (replicate_state, barriers, the gradients' mean)."""
    world: DataGroup
    data: DataGroup         # the ranks of this space index
    space: DataGroup        # the ranks of this data index, by band
    n_data: int
    n_space: int

    pg = property(lambda self: self.world.pg)
    host = property(lambda self: self.world.host)
    rank = property(lambda self: self.world.rank)
    size = property(lambda self: self.world.size)
    device = property(lambda self: self.world.device)
    backend = property(lambda self: self.world.backend)


def init_group(backend, device=None, *, rank=None, world_size=None,
               init_method=None, gloo_on_cuda=False,
               timeout_s=multihost.DEFAULT_TIMEOUT_S):
    """Join (with the others, form) the data-parallel group; returns this
    rank's DataGroup.

    backend: "nccl" for ranks on cards, "gloo" for ranks on the CPU. gloo
    on CUDA tensors (two ranks sharing one card, which NCCL refuses) only
    with gloo_on_cuda=True. device: None is the card of torchrun's
    LOCAL_RANK (else of the rank), made the current device before anything
    else; "cpu" for CPU ranks. rank, world_size and init_method
    default to torchrun's environment (multihost.initialize)."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl takes ranks on cards, not {dev}")
    if backend == "gloo" and dev.type == "cuda" and not gloo_on_cuda:
        raise ValueError(
            "gloo with ranks on cards: pass backend='nccl', or "
            "gloo_on_cuda=True where ranks share a card")
    multihost.initialize(backend, init_method, world_size, rank, timeout_s)
    host = dist.group.WORLD if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=timedelta(seconds=timeout_s))
    return DataGroup(dist.group.WORLD, host, dist.get_rank(),
                     dist.get_world_size(), dev, backend,
                     tuple(range(dist.get_world_size())))


def _sub_group(world, ranks, timeout_s):
    """A DataGroup over `ranks` of the world (every rank of the world calls
    this for every sub-group, in one order); None where this rank is not
    among them."""
    pg = dist.new_group(list(ranks))
    host = pg if world.backend == "gloo" else dist.new_group(
        list(ranks), backend="gloo", timeout=timedelta(seconds=timeout_s))
    if world.rank not in ranks:
        return None
    return DataGroup(pg, host, ranks.index(world.rank), len(ranks),
                     world.device, world.backend, tuple(ranks))


def make_mesh_2d(n_data, n_space, backend, device=None, *, rank=None,
                 world_size=None, init_method=None, gloo_on_cuda=False,
                 timeout_s=multihost.DEFAULT_TIMEOUT_S):
    """Join (with the others, form) a (data, space) group of n_data x
    n_space ranks (resuneta_tpu/parallel/mesh.py:47-54); returns this rank's
    SpaceMesh. The arguments are init_group's, and the world must hold
    n_data x n_space ranks. The axes come from dist.new_group, which takes
    every backend and gloo on cards; torch's init_device_mesh names a device
    type and binds a rank's card by its rank, which ranks sharing one card
    cannot use."""
    world = init_group(backend, device, rank=rank, world_size=world_size,
                       init_method=init_method, gloo_on_cuda=gloo_on_cuda,
                       timeout_s=timeout_s)
    if world.size != n_data * n_space:
        destroy_group(world)
        raise ValueError(f"a {n_data} x {n_space} mesh needs "
                         f"{n_data * n_space} ranks, the world has "
                         f"{world.size}")
    grid = [tuple(i * n_space + j for j in range(n_space))
            for i in range(n_data)]
    space = [_sub_group(world, row, timeout_s) for row in grid]
    data = [_sub_group(world, col, timeout_s) for col in zip(*grid)]
    i, j = divmod(world.rank, n_space)
    return SpaceMesh(world, data[j], space[i], n_data, n_space)


def destroy_group(group):
    """Leave the process group (every rank, at its end)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch, group):
    """This rank's contiguous rows of a global batch (a dict of arrays or
    tensors, or one of them), as P('data') lays them out; the batch itself
    without a group. Over a SpaceMesh the rows of its data axis. Raises
    where R does not divide the batch."""
    if group is None:
        return batch
    group = getattr(group, "data", group)
    n = len(next(iter(batch.values())) if isinstance(batch, dict) else batch)
    lo, hi = multihost.host_batch_slice(n, group.size, group.rank)
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]


def spatial_batch_sharding(mesh, batch_size, height):
    """This rank's (rows, band) slices of a (batch_size, height, ...)
    array, as P('data', 'space') lays it out. Raises where n_data does not
    divide the batch or n_space the height."""
    if height % mesh.n_space:
        raise ValueError(f"height {height} not divisible by the "
                         f"{mesh.n_space} bands of the space axis")
    lo, hi = multihost.host_batch_slice(batch_size, mesh.n_data,
                                        mesh.data.rank)
    h = height // mesh.n_space
    return slice(lo, hi), slice(mesh.space.rank * h, (mesh.space.rank + 1) * h)


def shard_batch_spatial(batch, mesh):
    """This rank's part of a global batch (a dict of arrays or tensors, or
    one of them; resuneta_tpu/parallel/mesh.py:63-73): arrays of 2 or more
    dimensions their rows over data and their band of rows (axis 1) over
    space, 1-D arrays (`aug`) their rows over data."""
    def part(x):
        if x.ndim >= 2:
            rows, band = spatial_batch_sharding(mesh, len(x), x.shape[1])
            return x[rows, band]
        return shard_batch(x, mesh)

    if isinstance(batch, dict):
        return {k: part(v) for k, v in batch.items()}
    return part(batch)


def _broadcast_(t, group):
    """Broadcast t from rank 0 in place, through the group's device where
    the backend needs it (NCCL takes no CPU tensor)."""
    if group.backend == "nccl" and t.device != group.device:
        buf = t.to(group.device)
        dist.broadcast(buf, 0, group=group.pg)
        t.copy_(buf)
    else:
        dist.broadcast(t, 0, group=group.pg)


@torch.no_grad()
def replicate_state(state, group):
    """Give every rank rank 0's train state: the parameters and BN buffers,
    the optimizer's state tensors and settings, and the step count.
    Returns the state (changed in place); the state itself without a
    group."""
    if group is None:
        return state
    for t in list(state.model.parameters()) + list(state.model.buffers()):
        _broadcast_(t.data, group)
    opt = state.optimizer
    meta = [state.step, [{k: v for k, v in g.items() if k != "params"}
                         for g in opt.param_groups],
            [sorted(opt.state[p]) for g in opt.param_groups
             for p in g["params"]]]
    dist.broadcast_object_list(meta, 0, group=group.host)
    state.step = meta[0]
    for g, settings in zip(opt.param_groups, meta[1]):
        g.update(settings)
    params = [p for g in opt.param_groups for p in g["params"]]
    for p, keys in zip(params, meta[2]):
        if sorted(opt.state[p]) != keys:
            raise RuntimeError(
                "replicate_state: the optimizer state of a parameter has "
                f"keys {sorted(opt.state[p])} here and {keys} on rank 0")
        for k in keys:
            if isinstance(opt.state[p][k], torch.Tensor):
                _broadcast_(opt.state[p][k], group)
    return state
