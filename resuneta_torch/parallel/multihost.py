"""Processes of a data-parallel run (resuneta_tpu/parallel/multihost.py).

The port runs one process a card, on one host or several, joined by
torch.distributed: `initialize` forms the process group (from torchrun's
environment, or from an explicit rank, world size and init_method), and the
helpers below say which process this is. Each process loads only its rows
of every global batch (`host_batch_slice`, `shard_host_indices`, the same
functions as the JAX package's, in numpy), checkpoints and logs only on the
coordinator (rank 0), and waits for the others at a `barrier` with a
timeout.
"""

import os
from datetime import timedelta

import numpy as np
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def initialize(backend, init_method=None, world_size=None, rank=None,
               timeout_s=DEFAULT_TIMEOUT_S):
    """torch.distributed.init_process_group with the given backend ("nccl"
    or "gloo", never chosen here) and a timeout on the rendezvous and on
    every collective. Where world_size and rank are None they come from
    torchrun's WORLD_SIZE and RANK, and init_method None is "env://"
    (MASTER_ADDR, MASTER_PORT)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator(group=None):
    """True on the process that checkpoints and logs: rank 0 of `group`
    (a DataGroup), or of the process group; True without either."""
    if group is not None:
        return group.rank == 0
    return process_index() == 0


def barrier(group, name, timeout_s=DEFAULT_TIMEOUT_S):
    """Wait until every rank of `group` (a DataGroup; None: return at once)
    reaches this barrier, at most timeout_s: then raise, naming the
    barrier. It runs on the group's gloo channel (monitored_barrier), so it
    needs no device and reports the ranks that did not arrive."""
    if group is None:
        return
    try:
        dist.monitored_barrier(group.host, timeout=timedelta(
            seconds=timeout_s), wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def host_batch_slice(global_batch_size, n_hosts=None, host_id=None):
    """The [start, stop) rows of this process's shard of a global batch,
    which must divide evenly over the processes."""
    n_hosts = process_count() if n_hosts is None else n_hosts
    host_id = process_index() if host_id is None else host_id
    if global_batch_size % n_hosts:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {n_hosts} hosts")
    per = global_batch_size // n_hosts
    return host_id * per, (host_id + 1) * per


def shard_host_indices(n_samples, n_hosts=None, host_id=None, seed=0,
                       epoch=0):
    """This process's samples of one epoch: every process draws the same
    permutation (seeded by (seed, epoch)) and takes its contiguous slice, so
    the union over processes is one epoch without duplicates; the tail
    remainder is dropped so every process holds as many."""
    n_hosts = process_count() if n_hosts is None else n_hosts
    host_id = process_index() if host_id is None else host_id
    perm = np.random.default_rng((seed, epoch)).permutation(n_samples)
    per = n_samples // n_hosts
    return perm[host_id * per:(host_id + 1) * per]


def assemble_global_batch(local_batch, group=None):
    """The identity. In the JAX package this stitches the processes' shards
    into one global array; here each rank's step takes its own shard as it
    is, and the batch-coupled reductions inside the step make it compute on
    the global batch (parallel/axis.py)."""
    return local_batch
