"""The data and space axes of a distributed step
(resuneta_tpu/parallel/axis.py; the reference's 'space' axis, GSPMD over a
(data, space) mesh, resuneta_tpu/parallel/mesh.py:47-73).

Each rank of a data-parallel step holds B/R rows of a global batch of B.
The reductions that couple the rows of a batch, the BatchNorm statistics
(ops/fused_bn.bn_stats), the Tanimoto class volumes (losses.tanimoto_loss),
the loss means and the metric counts, must then reduce over every rank to
compute what one device computes on all B rows (sync-BN; the reference's
MirroredStrategy contract, train_ISPRS.py:347-348).

Over a 2-D group (parallel.mesh.SpaceMesh) each rank holds, besides its
rows, one band of H/S rows of every image and activation. A 3x3 conv then
reads `halo(x, d)`: its band with d rows of each neighbour above and below
(zeros past the image's edge); a layer that needs whole planes reads
`gather_space(x)` and keeps `band(y)`. The reductions say which axes they
span: BN moments and loss means average over both (every band has the same
size), the Tanimoto sums over H, W sum over space and average over data,
the metric counts sum over both.

Rather than thread a group through every op's signature, the step
(train/steps.py) runs its body inside `data_axis(group)` (a DataGroup: the
data axis alone; a SpaceMesh: both); the ops call `pmean`/`psum`, which
all-reduce over the active axes and are the identity where none is active
(one process, or `data_axis(None)`), and the models call `halo` where
`space_live()`.

Every collective is an autograd function whose backward applies the
transpose JAX applies under shard_map(check_vma=False): pmean's and psum's
backward all-reduce the cotangent the same way, the halo's sends each
halo row's cotangent back to its owner, which adds it, and the gather's
sums the cotangents over space and keeps the band. With the step's mean of
the gradients over every rank (train/steps.py `_pmean_grads`) that is the
unsharded step's gradient. The group is kept on the autograd node, so the
backward, which autograd may run on another thread, needs no context. A
tuple of tensors goes through one flat all-reduce.

gloo takes CPU tensors only for point-to-point and all-gather: over gloo
(ranks sharing a card) the halos and gathers go through the host; over
NCCL they stay on the card. The backend is the group's, never switched
here.
"""

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist

AXES = ("data", "space")
_GROUP = contextvars.ContextVar("resuneta_torch_data_axis", default=None)


@contextlib.contextmanager
def data_axis(group):
    """Make `group` the axes of the enclosed code: a parallel.mesh.DataGroup
    (the data axis), a parallel.mesh.SpaceMesh (data and space), or
    None."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def current_group():
    """The active DataGroup or SpaceMesh, or None."""
    return _GROUP.get()


def space_group():
    """The active mesh's space axis (a DataGroup over the ranks of this
    rank's rows), where it spans more than one rank; else None."""
    g = _GROUP.get()
    space = getattr(g, "space", None)
    return space if space is not None and space.size > 1 else None


def space_live():
    return space_group() is not None


def refuse_space(what):
    """Raise under a live space axis: `what` has no band-sharded form."""
    if space_live():
        raise ValueError(f"{what} does not run height-sharded over a "
                         "space axis; use ResUnetA or UNet")


def check_band(h, multiple, what):
    """Raise unless a band of h rows divides into every level of a model
    whose deepest level is H/multiple: H divisible by n_space * multiple."""
    space = space_group()
    if space is not None and h % multiple:
        raise ValueError(
            f"{what} over {space.size} bands needs H divisible by "
            f"{space.size} x {multiple} (a band of h rows at every level); "
            f"got bands of {h} rows, H = {h * space.size}")


def _reducer(axes):
    """The group that reduces over `axes` of the active ones, or None."""
    g = _GROUP.get()
    if g is None:
        return None
    if getattr(g, "space", None) is None:       # a DataGroup
        return g if "data" in axes else None
    if "data" in axes and "space" in axes:
        return g.world
    return g.data if "data" in axes else g.space


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


def _reduce(x, mean, axes):
    group = _reducer(axes)
    if group is None or group.size == 1:
        return x
    if isinstance(x, torch.Tensor):
        return _AllReduce.apply(group, mean, x)[0]
    return type(x)(_AllReduce.apply(group, mean, *x))


def pmean(x, axes=AXES):
    """Mean of a tensor, or of each of a tuple of tensors, over the active
    ones of `axes` (identity without one)."""
    return _reduce(x, True, axes)


def psum(x, axes=AXES):
    """Sum over the active ones of `axes` (identity without one)."""
    return _reduce(x, False, axes)


# ------------------------------------------------------------ the space axis

def _on_card(group, t):
    """True where t travels on the card (NCCL), False where through the
    group's gloo channel on the host."""
    return group.backend == "nccl" and t.device.type == "cuda"


def _exchange(group, sends, recvs, like):
    """Point-to-point over the space group: sends {space index: tensor},
    recvs {space index: shape}; returns {space index: tensor received}, on
    the device and in the dtype of `like`. Every send and receive is posted
    before any is waited on."""
    ranks, card = group.ranks, _on_card(group, like)
    bufs = {p: torch.empty(s, dtype=like.dtype, device=like.device if card
                           else "cpu")
            for p, s in recvs.items()}
    if card:
        ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[p], group.pg)
               for p, t in sends.items()] + \
              [dist.P2POp(dist.irecv, b, ranks[p], group.pg)
               for p, b in bufs.items()]
        works = dist.batch_isend_irecv(ops)
    else:
        keep = {p: t.contiguous().cpu() for p, t in sends.items()}
        works = [dist.isend(t, ranks[p], group=group.host)
                 for p, t in keep.items()] + \
                [dist.irecv(b, ranks[p], group=group.host)
                 for p, b in bufs.items()]
    for w in works:
        w.wait()
    return {p: b.to(like.device) for p, b in bufs.items()}


def _halo_pieces(h, rows):
    """[(k, n)]: the halo's k-th neighbour on each side (space index j - k
    above, j + k below) gives n of its rows (all h but the farthest);
    k runs while the halo reaches, whether or not the neighbour exists."""
    return [(k, min(h, rows - (k - 1) * h))
            for k in range(1, math.ceil(rows / h) + 1)]


def _halo_fwd(x, rows, group):
    N, C, h, W = x.shape
    j, S = group.rank, group.size
    pieces = _halo_pieces(h, rows)
    sends, recvs = {}, {}
    for k, n in pieces:
        if j + k < S:   # my bottom n rows: the top halo of j + k
            sends[j + k] = x[:, :, h - n:]
            recvs[j + k] = (N, C, n, W)
        if j - k >= 0:
            sends[j - k] = x[:, :, :n]
            recvs[j - k] = (N, C, n, W)
    got = _exchange(group, sends, recvs, x)

    def piece(p, n):
        return got[p] if p in got else x.new_zeros((N, C, n, W))

    top = [piece(j - k, n) for k, n in reversed(pieces)]
    bottom = [piece(j + k, n) for k, n in pieces]
    return torch.cat(top + [x] + bottom, dim=2)


def _halo_bwd(g, rows, group):
    N, C, H2, W = g.shape
    h = H2 - 2 * rows
    j, S = group.rank, group.size
    pieces = _halo_pieces(h, rows)
    sends, recvs = {}, {}
    at = rows
    for k, n in pieces:       # the top halo, nearest piece last
        at -= n
        if j - k >= 0:
            sends[j - k] = g[:, :, at:at + n]
            recvs[j - k] = (N, C, n, W)
    at = rows + h
    for k, n in pieces:
        if j + k < S:
            sends[j + k] = g[:, :, at:at + n]
            recvs[j + k] = (N, C, n, W)
        at += n
    got = _exchange(group, sends, recvs, g)
    dx = g[:, :, rows:rows + h].clone()
    for k, n in pieces:
        if j + k < S:   # cotangents of my bottom rows, from below
            dx[:, :, h - n:] += got[j + k]
        if j - k >= 0:
            dx[:, :, :n] += got[j - k]
    return dx


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, group):
        ctx.rows, ctx.group = rows, group
        return _halo_fwd(x, rows, group)

    @staticmethod
    def backward(ctx, g):
        return _halo_bwd(g, ctx.rows, ctx.group), None, None


def halo(x, rows):
    """Under a live space axis: the band x (N, C, h, W) with `rows` (> 0)
    rows above and below from the bands of the space axis (as many
    neighbours as the halo reaches), zeros past the image's edge: (N, C,
    h + 2 rows, W). Its backward adds each halo row's cotangent to the row
    it came from."""
    return _Halo.apply(x, rows, space_group())


def _all_gather(t, group, dim):
    """The group's tensors t concatenated along dim in rank order, on t's
    device (through the host over gloo)."""
    card = _on_card(group, t)
    src = (t if card else t.cpu()).contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg if card else group.host)
    return torch.cat(parts, dim=dim).to(t.device)


def _all_reduce_sum(t, group):
    card = _on_card(group, t)
    src = (t if card else t.cpu()).contiguous()
    dist.all_reduce(src, group=group.pg if card else group.host)
    return src.to(t.device)


class _GatherSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.h = dim, group, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        # the transpose of the gather: the cotangents summed over space,
        # this rank's band kept
        j, h = ctx.group.rank, ctx.h
        return _all_reduce_sum(g, ctx.group).narrow(ctx.dim, j * h, h), \
            None, None


def gather_space(x, dim=2):
    """The whole planes of the band x, its bands concatenated along `dim`
    (rows: 2 for NCHW, 1 for NHWC) in space order, the same on every rank
    of the space axis; x itself without one. Differentiable."""
    group = space_group()
    return x if group is None else _GatherSpace.apply(x, dim, group)


def band(x, dim=2):
    """This rank's band of rows (along `dim`) of a whole-plane tensor; x
    itself without a space axis."""
    group = space_group()
    if group is None:
        return x
    h = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * h, h)
