"""The data-parallel group (resuneta_tpu/parallel/mesh.py:37-107): the
counterpart of the JAX package's 1-D 'data' mesh.

A DataGroup is one process a rank, R ranks, each with its device: the
process group whose collectives carry the step's reductions (NCCL between
cards, gloo between CPU processes), a gloo channel for host-side work
(barriers, the gather of inference outputs), this rank and R. Each rank's
step sees B/R contiguous rows of the global batch of B (`shard_batch`, as
P('data') lays them out), and every rank starts from rank 0's parameters,
buffers and optimizer state (`replicate_state`).

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
                     dist.get_world_size(), dev, backend)


def destroy_group(group):
    """Leave the process group (every rank, at its end)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch, group):
    """This rank's contiguous rows of a global batch (a dict of arrays or
    tensors, or one of them), as P('data') lays them out; the batch itself
    without a group. Raises where R does not divide the batch."""
    if group is None:
        return batch
    n = len(next(iter(batch.values())) if isinstance(batch, dict) else batch)
    lo, hi = multihost.host_batch_slice(n, group.size, group.rank)
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]


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
