"""make_train_step(remat=True) (resuneta_torch/train/steps.py; the
reference's jax.checkpoint of the forward under SAVE_CONVS,
resuneta_tpu/train/steps.py:31-40, :151-152) on the CPU, torch only.

The 64 px multitask d6 step with remat equals the step without it bit for
bit, in the NHWC routing and on the dense trunk (K3/K4's plain versions):
the metric row, every gradient, the updated parameters and the BN running
buffers. The rerun of a block in the backward leaves the buffers alone, so
each BN updates them once a step. The forward keeps fewer bytes for the
backward: what autograd saves outside the checkpointed blocks (summed
over distinct storages through torch.autograd.graph.saved_tensors_hooks)
plus what the selective policy keeps inside them."""

import threading

import numpy as np
import pytest
import torch

from resuneta_torch import losses
from resuneta_torch.data import make_device_pipeline
from resuneta_torch.models import ResUnetA, norm
from resuneta_torch.ops import convseg, densemm, poolconv
from resuneta_torch.train import create_train_state, make_train_step, steps
from test_torch_labels import voronoi_ids
from util_torch import one_thread  # noqa: F401  (a fixture)
from util_torch import one_thread_under_xdist

HEADS = ("seg", "bound", "dist", "color")


def _raw():
    rng = np.random.default_rng(11)
    return {"image_u8": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
            "label_ids": voronoi_ids(2, 64, 5, 11).astype(np.uint8),
            "aug": np.array([2, 1], np.int32)}


def _step(remat, dense, monkeypatch):
    """One Adam step from seeded weights; returns the row, gradients,
    state, the BN update log, the kernels' CPU calls and the saved
    bytes."""
    model = ResUnetA(5, img_size=64, device="cpu", dense_trunk=dense,
                     generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, "adam", 1e-4)
    step = make_train_step(losses.make_losses("tanimoto"),
                           dict.fromkeys(HEADS, 1.0), True,
                           preprocess=make_device_pipeline(5, 1,
                                                           device="cpu"),
                           device="cpu", remat=remat)
    updates = []
    real_stats = norm.BatchNorm.batch_stats

    def logged(self, x, stats=None):
        updates.append(not norm._FROZEN.get())
        return real_stats(self, x, stats)

    kept = {}
    real_policy = steps.SAVE_CONVS

    def policy(ctx, op, *args, **kwargs):
        out = real_policy(ctx, op, *args, **kwargs)
        if out == steps.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            outs = ctx.op_output if isinstance(ctx.op_output, tuple) \
                else (ctx.op_output,)
            for t in outs:
                st = t.untyped_storage()
                kept[st.data_ptr()] = st.nbytes()
        return out

    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t

    monkeypatch.setattr(norm.BatchNorm, "batch_stats", logged)
    monkeypatch.setattr(steps, "SAVE_CONVS", policy)
    mods = (convseg, densemm, poolconv)
    calls = [m.CALLS for m in mods]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        state, row = step(state, _raw())
    monkeypatch.undo()
    return {"row": row, "state": model.state_dict(),
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "updates": updates,
            "calls": tuple(m.CALLS - c for m, c in zip(mods, calls)),
            "saved_bytes": sum(saved.values()) + sum(kept.values())}


@pytest.fixture(scope="module", params=[False, True], ids=["nhwc", "dense"])
def runs(request):
    """Both steps of a routing, on one torch thread under several test
    workers (the rematerialised step's dispatch mode makes many small
    ops)."""
    with one_thread_under_xdist():
        with pytest.MonkeyPatch.context() as mp:
            plain = _step(False, request.param, mp)
        with pytest.MonkeyPatch.context() as mp:
            remat = _step(True, request.param, mp)
    return request.param, plain, remat


@pytest.mark.usefixtures("one_thread")
def test_remat_step_equals_the_plain_step(runs):
    _, plain, remat = runs
    assert torch.equal(remat["row"], plain["row"])
    assert sorted(remat["grads"]) == sorted(plain["grads"])
    for k, g in plain["grads"].items():
        assert torch.equal(remat["grads"][k], g), k
    for k, v in plain["state"].items():          # parameters and buffers
        assert torch.equal(remat["state"][k], v), k


@pytest.mark.usefixtures("one_thread")
def test_bn_buffers_update_once(runs):
    """Every BN forward updates its buffers once; the reruns (each of the
    ResBlocks', PSPs', Combines' and UpSampleConvs' BNs again) do not."""
    _, plain, remat = runs
    assert all(plain["updates"])
    n_bn = len(plain["updates"])
    assert remat["updates"].count(True) == n_bn
    assert remat["updates"].count(False) == n_bn


@pytest.mark.usefixtures("one_thread")
def test_remat_reruns_the_forward_kernels_and_saves_fewer_bytes(runs):
    """The segments (K1's plain version) and, on the dense trunk, the K3
    and K4 calls inside the checkpointed blocks run again in the backward:
    44 more K1 calls, 9 more K3 calls (all but the three stride-2 convs)
    and the PSP's one pooled level's K4 call again. The bytes kept for
    the backward fall (at 64 px x 2 to well under half)."""
    dense, plain, remat = runs
    assert plain["calls"] == ((44, 12, 1) if dense else (44, 0, 0))
    assert remat["calls"] == ((88, 21, 2) if dense else (88, 0, 0))
    assert remat["saved_bytes"] < 0.5 * plain["saved_bytes"], \
        (remat["saved_bytes"], plain["saved_bytes"])


def test_rerun_sees_the_forward_data_axis_and_freezes_buffers():
    """A block's rerun in the backward sees the data axis its forward saw
    and runs with the BN running buffers frozen, though the backward runs
    on another thread (as autograd runs a card's backward), where the
    step's context is not set."""
    from resuneta_torch.models.resuneta import checkpointed, remat
    from resuneta_torch.parallel import axis

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))
            self.seen = []

        def forward(self, x):
            self.seen.append((axis.current_group(), norm._FROZEN.get()))
            return torch.relu(x * self.w) * 2

    probe = Probe()
    group = object()                       # stands for a DataGroup
    with axis.data_axis(group), remat(steps.SAVE_CONVS):
        y = checkpointed(probe, torch.randn(4, 3)).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert probe.seen == [(group, False), (group, True)]
    assert probe.w.grad is not None
