"""The PyTorch port's train step in the dense-trunk routing
(ResUnetA(dense_trunk=True): the 1x1 convs of the shallow levels and the
tail through K3 and K4) against the JAX package's dense trunk on the CPU,
and against the port's own NHWC routing.

The JAX step is resuneta_tpu.train.make_train_step at 64 px, bs 2, f32
with RESUNETA_DENSE_TRUNK=1 and RESUNETA_DENSEMM_INTERPRET=1 set before it
is traced: its K3 and K4 run as Pallas kernels in interpret mode (12 and 1
calls), its segments on their CPU fallback (resuneta.py:287-297). The port
runs K3/K4's plain versions, and its segments through K1/K2's plain
versions (bf16 z and taps) or, with the segment gate off, as f32 convs like
JAX's. One JAX step serves the module; the limits are
tests/test_torch_train.py's, for the same reasons (stated there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from resuneta_torch import convert, losses
from resuneta_torch import models as tm
from resuneta_torch.data import make_device_pipeline
from resuneta_torch.ops import convseg, densemm, poolconv
from resuneta_torch.train import create_train_state, make_train_step
from resuneta_tpu import losses as jlosses
from resuneta_tpu.data import make_device_pipeline as jmake_device_pipeline
from resuneta_tpu.models import resuneta as jm
from resuneta_tpu.ops.pallas import densemm as jdensemm
from resuneta_tpu.ops.pallas import poolconv as jpoolconv
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train.state import TrainState as JTrainState
from test_torch_train import (BS, LR, NC, PS, WEIGHTS, _grad_err, _grads,
                              _raw_batch, _stash, step_variables)

HEAD_LEAVES = ("seg1", "seg2", "seg3", "Conv_6", "Conv_7", "Conv_9",
               "Conv_10", "Conv_11")
COUNTERS = ((convseg, "CALLS"), (convseg, "BWD_CALLS"), (densemm, "CALLS"),
            (densemm, "BWD_CALLS"), (poolconv, "CALLS"),
            (poolconv, "BWD_CALLS"))


@functools.cache
def _jax_dense_step():
    """The reference's dense-trunk step, once: variables, raw batch, new
    state, row, and the K3/K4 calls of one trace of its train forward."""
    calls = {"K3": 0, "K4": 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RESUNETA_DENSE_TRUNK", "1")
        mp.setenv("RESUNETA_DENSEMM_INTERPRET", "1")
        jmod = jm.ResUnetA(NC, img_size=PS, multitasking=True)
        variables = step_variables()
        raw = _raw_batch()
        tx = optax.chain(_stash(), optax.adam(LR, b1=0.9))
        jstate = JTrainState(step=jnp.asarray(0, jnp.int32),
                             params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]), tx=tx,
                             apply_fn=jmod.apply)
        jstep = jmake_train_step(jlosses.make_losses("tanimoto"), WEIGHTS,
                                 True, preprocess=jmake_device_pipeline(NC, 1),
                                 donate=False)
        jnew, jrow = jstep(jstate,
                           {k: jnp.asarray(v) for k, v in raw.items()})
        jrow = np.asarray(jrow)
        for mod, name, key in ((jdensemm, "dense_mm", "K3"),
                               (jpoolconv, "pool_conv", "K4")):
            def counted(*a, _f=getattr(mod, name), _k=key):
                calls[_k] += 1
                return _f(*a)
            mp.setattr(mod, name, counted)
        jax.eval_shape(lambda v: jmod.apply(
            v, jnp.zeros((BS, PS, PS, 3)), train=True,
            mutable=["batch_stats"]), variables)
    return variables, raw, jnew, jrow, dict(calls)


def _port_step(variables, raw, dense_trunk):
    model = tm.ResUnetA(NC, img_size=PS, multitasking=True, device="cpu",
                        dense_trunk=dense_trunk)
    model.load_state_dict(convert.from_flax(variables, model), strict=True)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, "adam", LR)
    step = make_train_step(losses.make_losses("tanimoto"), WEIGHTS, True,
                           preprocess=make_device_pipeline(NC, 1,
                                                           device="cpu"),
                           device="cpu")
    counts = [getattr(m, k) for m, k in COUNTERS]
    state, row = step(state, raw)
    counts = [getattr(m, k) - c for (m, k), c in zip(COUNTERS, counts)]
    return {"model": model, "state": state, "row": row.numpy(),
            "before": before, "counts": counts}


def _run(fused):
    variables, raw, jnew, jrow, jcalls = _jax_dense_step()
    with pytest.MonkeyPatch.context() as mp:
        if not fused:
            mp.setattr(convseg, "available", lambda *a, **k: False)
        run = _port_step(variables, raw, True)
    run.update(variables=variables, jnew=jnew, jrow=jrow, jcalls=jcalls,
               raw=raw)
    return run


@pytest.fixture(scope="module")
def dense():
    """The slice's path on the CPU: K1/K2 and K3/K4's plain versions."""
    return _run(True)


@pytest.fixture(scope="module")
def dense_unfused():
    """The same with the segment gate off (f32 segment convs, as JAX's)."""
    return _run(False)


def test_dense_step_runs_k3_and_k4(dense, dense_unfused):
    """JAX's dense trunk reaches K3 12 times and K4 once at 64 px (the PSP
    pools only at k = 2 there); the port's calls them as often each way,
    beside its 44 fused segments (none with the gate off)."""
    assert dense["jcalls"] == {"K3": 12, "K4": 1}
    assert dense["counts"] == [44, 44, 12, 12, 1, 1]
    assert dense_unfused["counts"] == [0, 0, 12, 12, 1, 1]
    assert dense["state"].step == 1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dense_metrics_row_matches(fused, dense, dense_unfused):
    """Losses within 2e-3 relative; accuracy and threshold counts within
    0.2% of the pixels (tests/test_torch_train.py)."""
    run = dense if fused else dense_unfused
    got, want = run["row"], run["jrow"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:5], want[:5], rtol=2e-3)
    assert abs(got[5] - want[5]) <= 2e-3
    n = BS * PS * PS * NC
    np.testing.assert_allclose(got[6:], want[6:], rtol=0, atol=2e-3 * n)


def test_dense_every_gradient_matches_unfused(dense_unfused):
    """Every parameter's gradient within 3e-2 relative L2, the gradient
    tree through convert.from_flax."""
    got, want = _grads(dense_unfused)
    errs = {k: _grad_err(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] < 3e-2, (worst, errs[worst])


def test_dense_fused_gradients_stay_within_the_bf16_band(dense):
    """With the port's segments in bf16 (K1/K2) and JAX's in f32: all
    gradients at once within 0.1 relative L2, the heads within 3e-2."""
    got, want = _grads(dense)
    a = np.concatenate([got[k].numpy().ravel() for k in want])
    b = np.concatenate([want[k].numpy().ravel() for k in want])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.1
    heads = [k for k in want if k.split(".")[0] in HEAD_LEAVES]
    assert len(heads) == 16
    worst = max(_grad_err(got[k].numpy(), want[k].numpy()) for k in heads)
    assert worst < 3e-2, worst


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dense_bn_running_statistics_match(fused, dense, dense_unfused):
    """Every BN's running buffers within 5e-3 relative L2, and all moved."""
    run = dense if fused else dense_unfused
    want = convert.from_flax({"batch_stats": run["jnew"].batch_stats})
    now = run["model"].state_dict()
    worst = max(_grad_err(now[k].numpy(), v.numpy(), atol=0)
                for k, v in want.items())
    assert worst < 5e-3, worst
    moved = [k for k in want if not torch.equal(now[k], run["before"][k])]
    assert len(moved) == len(want)


def test_dense_adam_update_matches_unfused(dense_unfused):
    """The first Adam update: sign flips below 1% of the elements, the rest
    within 0.1 relative L2; zero-gradient biases move by at most lr."""
    run = dense_unfused
    jparams = convert.from_flax({"params": run["jnew"].params})
    p0 = convert.from_flax({"params": run["variables"]["params"]})
    jgrads = _grads(run)[1]
    now = run["model"].state_dict()
    n_flip = n_tot = 0
    worst = 0.0
    for k, want in jparams.items():
        if np.linalg.norm(jgrads[k].numpy()) < 1e-6:
            assert (now[k] - p0[k]).abs().max() <= LR * 1.001, k
            continue
        du_o = (now[k] - p0[k]).numpy().astype(np.float64).ravel()
        du_j = (want - p0[k]).numpy().astype(np.float64).ravel()
        flip = du_o * du_j < 0
        n_flip += int(flip.sum())
        n_tot += flip.size
        worst = max(worst, _grad_err(du_o[~flip], du_j[~flip], atol=4e-6))
    assert n_flip / n_tot < 0.01, (n_flip, n_tot)
    assert worst < 0.1, worst


# ------------------------------------------- the port's two routings

def _own_routing(dense_trunk):
    """One train-mode forward and backward of the port at 64 px, bs 2, f32,
    the segment gate off, loss = sum of the squared outputs (the
    reference's TestDenseTrunk, tests/test_models.py:237-260)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, PS, PS, 3)).astype(
        np.float32))
    model = tm.ResUnetA(NC, img_size=PS, device="cpu",
                        generator=torch.Generator().manual_seed(4),
                        dense_trunk=dense_trunk).train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convseg, "available", lambda *a, **k: False)
        calls = densemm.CALLS
        out = model(x)
        loss = sum((o.float() ** 2).sum() for o in out.values())
        loss.backward()
        calls = densemm.CALLS - calls
    grads = {k: p.grad for k, p in model.named_parameters()}
    return out, loss.item(), grads, dict(model.named_buffers()), calls


def test_dense_trunk_matches_the_nhwc_routing():
    """The same model, weights and input through the dense trunk and the
    NHWC routing, at TestDenseTrunk's limits (tests/test_models.py:
    282-295): outputs 2e-4 relative + 2e-5, the loss 1e-4, all gradients at
    once 5e-3 relative L2, the BN statistics 1e-5 + 1e-6. The parameter
    trees are the same."""
    o1, l1, g1, s1, c1 = _own_routing(True)
    o0, l0, g0, s0, c0 = _own_routing(False)
    assert (c1, c0) == (12, 0)
    assert sorted(g1) == sorted(g0) and sorted(s1) == sorted(s0)
    for k in o0:
        np.testing.assert_allclose(o1[k].detach().numpy(),
                                   o0[k].detach().numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    du = torch.cat([(g1[k] - g0[k]).ravel() for k in g0])
    nrm = torch.cat([g0[k].ravel() for k in g0])
    assert (du.norm() / nrm.norm()).item() < 5e-3
    for k in s0:
        np.testing.assert_allclose(s1[k].numpy(), s0[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_dense_trunk_gate():
    """None: on where the model is on the card (off on the CPU, as the
    reference is off the TPU); True needs the geometry (H == W, W % 32 ==
    0, W >= 64); train mode only."""
    m = tm.ResUnetA(NC, img_size=PS, device="cpu").train()
    assert not m.uses_dense_trunk(64, 64)
    m.dense_trunk = True
    assert m.uses_dense_trunk(64, 64) and m.uses_dense_trunk(256, 256)
    assert not any(m.uses_dense_trunk(h, w) for h, w in
                   ((64, 128), (48, 48), (32, 32), (80, 80)))
    assert not m.eval().uses_dense_trunk(64, 64)
    m.train().dense_trunk = False
    assert not m.uses_dense_trunk(64, 64)
