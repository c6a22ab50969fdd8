"""The data axis of a data-parallel step (resuneta_tpu/parallel/axis.py).

Each rank of a data-parallel step holds B/R rows of a global batch of B.
The reductions that couple the rows of a batch, the BatchNorm statistics
(ops/fused_bn.bn_stats), the Tanimoto class volumes (losses.tanimoto_loss),
the loss means and the metric counts, must then reduce over every rank to
compute what one device computes on all B rows (sync-BN; the reference's
MirroredStrategy contract, train_ISPRS.py:347-348).

Rather than thread a group through every op's signature, the step
(train/steps.py) runs its body inside `data_axis(group)`; the batch-coupled
ops call `pmean`/`psum`, which all-reduce over the active group and are the
identity where none is active (one process, or `data_axis(None)`).

Both are autograd functions whose backward all-reduces the cotangent the
same way: the transpose JAX applies to pmean/psum under
shard_map(check_vma=False). The group is kept on the autograd node, so the
backward, which autograd may run on another thread, needs no context. A
tuple of tensors goes through one flat all-reduce.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist

_GROUP = contextvars.ContextVar("resuneta_torch_data_axis", default=None)


@contextlib.contextmanager
def data_axis(group):
    """Make `group` (a parallel.mesh.DataGroup, or None) the data axis of
    the enclosed code."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def current_group():
    """The active DataGroup, or None."""
    return _GROUP.get()


def all_reduce_flat(tensors, group, mean):
    """Sum (or mean, the sum over the group's size) of each tensor over the
    group's ranks, through one flat all-reduce of their concatenation. The
    tensors must share a dtype and device; returns views of one new flat
    buffer, shaped as the tensors."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group.pg)
    if mean:
        flat /= group.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, mean, *xs):
        ctx.group, ctx.mean = group, mean
        # outputs of their own, not views of one buffer
        return tuple(t.clone() for t in all_reduce_flat(xs, group, mean))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *all_reduce_flat(gs, ctx.group, ctx.mean))


def _reduce(x, mean):
    group = current_group()
    if group is None:
        return x
    if isinstance(x, torch.Tensor):
        return _AllReduce.apply(group, mean, x)[0]
    return type(x)(_AllReduce.apply(group, mean, *x))


def pmean(x):
    """Mean of a tensor, or of each of a tuple of tensors, over the data
    axis (identity without one)."""
    return _reduce(x, mean=True)


def psum(x):
    """Sum over the data axis (identity without one)."""
    return _reduce(x, mean=False)
