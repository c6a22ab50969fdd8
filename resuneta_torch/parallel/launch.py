"""Start the ranks of a data-parallel run on one host.

`spawn(fn, nprocs, args)` runs fn(rank, *args) in nprocs fresh processes
(the spawn start method: a worker imports what it needs, and fn and args
are pickled, so fn is a module-level function). It returns when every rank
has returned; where one raises or dies, the others are stopped and spawn
raises, and past `timeout_s` it stops them all and raises TimeoutError.

`rendezvous(dirname)` names a file:// rendezvous in a directory of the
run's own, so that runs started at once on one host never share a port.

`main_data_parallel(run, args, ...)` is the train CLIs' --gpu_parallel (the
JAX CLI's, resuneta_tpu/cli/train_isprs.py:85-93; MirroredStrategy in
train_ISPRS.py:347-348) and their torchrun path.
"""

import json
import os
import tempfile
import time

from .multihost import DEFAULT_TIMEOUT_S


def rendezvous(dirname):
    """A file:// init_method in the directory `dirname`, one a run; the
    file must not exist before the ranks start."""
    path = os.path.join(os.path.abspath(dirname), "rendezvous")
    if os.path.exists(path):
        raise FileExistsError(f"{path} is left from an earlier run")
    return "file://" + path


def spawn(fn, nprocs, args=(), timeout_s=DEFAULT_TIMEOUT_S):
    """Run fn(rank, *args) for rank in range(nprocs), each in its own
    process; raise if a rank fails or the run outlasts timeout_s (None: no
    limit but the collectives' own timeouts)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{nprocs} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(timeout=30)


def _cli_rank(local_rank, run, args, world, init_method, history_path):
    """One spawned rank of main_data_parallel: NCCL, the card of its rank."""
    from .mesh import destroy_group, init_group

    group = init_group("nccl", f"cuda:{local_rank}", rank=local_rank,
                       world_size=world, init_method=init_method)
    try:
        _, history = run(args, group)
        if group.rank == 0:
            with open(history_path, "w") as f:
                json.dump(history, f)
    finally:
        destroy_group(group)


def main_data_parallel(run, args, device, gpu_parallel):
    """Run run(args, group) -> (state, history) as the train CLIs do:

    - under torchrun (WORLD_SIZE in the environment) this process joins
      that group as one rank: NCCL on the card of LOCAL_RANK, or gloo where
      `device` is the CPU (the multi-host path);
    - with gpu_parallel, the card as `device` and N > 1 visible cards: the
      kernels are built here once, then N ranks are spawned, one a card
      (NCCL), and this returns (None, rank 0's history): the trained state
      lives in the ranks, and rank 0's checkpoint holds it;
    - otherwise run(args, None) here, on one device (one card or none:
      gpu_parallel is then a no-op, as in the JAX CLI).

    `-bs` stays the global batch: each rank trains on its share."""
    import torch

    from ..device import resolve_device
    from .mesh import destroy_group, init_group

    dev = resolve_device(device)
    if "WORLD_SIZE" in os.environ:
        group = init_group("nccl" if dev.type == "cuda" else "gloo",
                           None if dev.type == "cuda" else "cpu")
        try:
            return run(args, group)
        finally:
            destroy_group(group)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if not gpu_parallel or n <= 1:
        return run(args, None)
    from ..kernels import build

    build.build_all()
    with tempfile.TemporaryDirectory(prefix="resuneta_ranks_") as tmp:
        history_path = os.path.join(tmp, "history.json")
        spawn(_cli_rank, n, (run, args, n, rendezvous(tmp), history_path),
              timeout_s=None)
        with open(history_path) as f:
            return None, json.load(f)
