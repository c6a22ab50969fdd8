"""The reference's opt-in train modes in the PyTorch port (ResUnetA's
segment_mode, bwd_wide, fwd_wide and dense_tail arguments) against the JAX
package's train step run with the matching environment variables, on the
CPU: segment mode "2" (RESUNETA_FUSED_TRAIN_SEGMENT=2: a plain forward and
K2's backward, the NHWC routing) and the wide tier (RESUNETA_CONVSEG_BWD_WIDE
=1: RB(256)'s segments through K1 + K9) here; tail mode "1" in
tests/test_torch_train_tail.py, with these helpers. And the modes' routing
rules on the port alone.

The steps are tests/test_torch_train.py's: 64 px, bs 2, f32, Tanimoto on
the four heads, one Adam step from the same seeded weights and raw batch.
Off the TPU the reference's segments run their plain form in every mode
(its gate needs the TPU), so the comparison holds the routing, the names
and the maths, not the kernels: the port's segments run K1/K2's plain
versions (bf16 z and taps; mode "2" only in the backward), and the limits
are tests/test_torch_train.py's for its fused step, for the reasons stated
there."""

import functools

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
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train.state import TrainState as JTrainState
from test_torch_train import (BS, LR, NC, PS, WEIGHTS, _grad_err, _grads,
                              _raw_batch, _stash, step_variables)

HEAD_LEAVES = ("seg1", "seg2", "seg3", "Conv_6", "Conv_7", "Conv_9",
               "Conv_10", "Conv_11")
# K1 calls, K2 calls, K3 calls each way, K4 calls each way
COUNTERS = ((convseg, "CALLS"), (convseg, "BWD_CALLS"), (densemm, "CALLS"),
            (densemm, "BWD_CALLS"), (poolconv, "CALLS"),
            (poolconv, "BWD_CALLS"))
# mode: (the reference's environment, the port's arguments, COUNTERS per
# step). Mode "2": no K1 call, the 44 K2 calls; the wide tier: RB(256)'s
# 12 segments more (RB(512) stays a conv: the backward's ceiling is 256)
MODES = {
    "segment_mode_2": ({"RESUNETA_FUSED_TRAIN_SEGMENT": "2"},
                       {"segment_mode": "2"}, [0, 44, 0, 0, 0, 0]),
    "bwd_wide": ({"RESUNETA_CONVSEG_BWD_WIDE": "1"}, {"bwd_wide": True},
                 [56, 56, 0, 0, 0, 0]),
}


@functools.cache
def jax_step(env):
    """The reference step under the environment `env` (a tuple of (name,
    value)), set while it is traced: variables, raw batch, new state,
    row."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env:
            mp.setenv(k, v)
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
    return variables, raw, jnew, np.asarray(jrow)


def run_mode(env, modes):
    """One step on each side: the reference under `env`, the port built
    with the arguments `modes`; the port's COUNTERS over its step."""
    variables, raw, jnew, jrow = jax_step(tuple(sorted(env.items())))
    model = tm.ResUnetA(NC, img_size=PS, multitasking=True, device="cpu",
                        **modes)
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
            "before": before, "counts": counts, "variables": variables,
            "jnew": jnew, "jrow": jrow}


def check_row(run):
    """Losses within 2e-3 relative; accuracy and the threshold counts
    within 0.2% of the pixels (tests/test_torch_train.py)."""
    got, want = run["row"], run["jrow"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:5], want[:5], rtol=2e-3)
    assert abs(got[5] - want[5]) <= 2e-3
    n = BS * PS * PS * NC
    np.testing.assert_allclose(got[6:], want[6:], rtol=0, atol=2e-3 * n)


def check_grads(run):
    """The fused step's band (tests/test_torch_train.py): all gradients at
    once within 0.1 relative L2, each head leaf within 3e-2."""
    got, want = _grads(run)
    a = np.concatenate([got[k].numpy().ravel() for k in want])
    b = np.concatenate([want[k].numpy().ravel() for k in want])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.1
    heads = [k for k in want if k.split(".")[0] in HEAD_LEAVES]
    assert len(heads) == 16
    worst = max(_grad_err(got[k].numpy(), want[k].numpy()) for k in heads)
    assert worst < 3e-2, worst


def check_bn_running(run):
    """Every BN's running buffers within 5e-3 relative L2, all moved."""
    want = convert.from_flax({"batch_stats": run["jnew"].batch_stats})
    now = run["model"].state_dict()
    worst = max(_grad_err(now[k].numpy(), v.numpy(), atol=0)
                for k, v in want.items())
    assert worst < 5e-3, worst
    moved = [k for k in want if not torch.equal(now[k], run["before"][k])]
    assert len(moved) == len(want)


@pytest.fixture(scope="module", params=sorted(MODES))
def mode(request):
    env, modes, counts = MODES[request.param]
    return run_mode(env, modes), counts


def test_mode_step_routes_its_segments(mode):
    run, counts = mode
    assert run["counts"] == counts
    assert run["state"].step == 1


def test_mode_metrics_row_matches(mode):
    check_row(mode[0])


def test_mode_gradients_stay_within_the_bf16_band(mode):
    check_grads(mode[0])


def test_mode_bn_running_statistics_match(mode):
    check_bn_running(mode[0])


# ------------------------------------------------ the routing rules alone

@pytest.mark.parametrize("segment_mode,dense_trunk,dense_tail,want", [
    ("1", True, None, (True, "2")),      # the card's default routing
    ("1", None, None, (False, "0")),     # the CPU's
    ("1", True, "0", (True, "0")),
    ("1", True, "1", (True, "1")),
    ("1", False, "1", (False, "1")),     # the tail alone on NHWC
    ("1", False, "2", (False, "2")),
    ("0", True, "1", (False, "0")),      # modes "0", "2": trunk, tail off
    ("2", True, "2", (False, "0")),
])
def test_mode_routing_rules(segment_mode, dense_trunk, dense_tail, want):
    """resuneta.py:502-523 and :615-653: segment modes "0" and "2" switch
    the dense trunk and the dense tail off; an explicit tail mode holds on
    either trunk where the geometry does; eval runs NHWC."""
    m = tm.ResUnetA(NC, img_size=PS, device="cpu", dense_trunk=dense_trunk,
                    segment_mode=segment_mode, dense_tail=dense_tail).train()
    assert (m.uses_dense_trunk(PS, PS), m.tail_mode(PS, PS)) == want
    assert m.tail_mode(PS, 60) == "0"    # W % 8 != 0: the NHWC tail
    m.eval()
    assert (m.uses_dense_trunk(PS, PS), m.tail_mode(PS, PS)) == (False, "0")


@pytest.mark.parametrize("kw", [{"segment_mode": "3"}, {"segment_mode": 1},
                                {"dense_tail": "3"}])
def test_mode_arguments_are_checked(kw):
    with pytest.raises(ValueError):
        tm.ResUnetA(NC, img_size=PS, device="cpu", **kw)


def test_modes_keep_the_parameter_tree():
    """Every mode builds the same parameter and buffer names, so
    convert.from_flax serves them all."""
    base = sorted(tm.ResUnetA(NC, img_size=PS, device="cpu").state_dict())
    for kw in ({"segment_mode": "2"}, {"bwd_wide": True, "fwd_wide": True},
               {"dense_tail": "1"}):
        assert sorted(tm.ResUnetA(NC, img_size=PS, device="cpu",
                                  **kw).state_dict()) == base
