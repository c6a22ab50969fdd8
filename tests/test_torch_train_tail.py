"""Tail mode "1" in the PyTorch port (ResUnetA(dense_tail="1") on the dense
trunk: Combine_5 and PSPPooling_1 through K3/K4, the five 3x3 head convs as
fused segments on an identity affine, the 1x1 logits plain convs) against
the JAX package's step with RESUNETA_DENSE_TAIL=1, RESUNETA_DENSE_TRUNK=1
and RESUNETA_DENSEMM_INTERPRET=1 (its K3/K4 in interpret mode, its head
convs in their plain form off the TPU), on the CPU, at the limits of
tests/test_torch_train_modes.py (which see)."""

import jax
import jax.numpy as jnp
import pytest

from resuneta_torch.ops import convseg
from resuneta_tpu.models import resuneta as jm
from resuneta_tpu.ops.pallas import densemm as jdensemm
from resuneta_tpu.ops.pallas import poolconv as jpoolconv
from test_torch_train import BS, NC, PS, step_variables
from test_torch_train_modes import (check_bn_running, check_grads,
                                    check_row, run_mode)

ENV = {"RESUNETA_DENSE_TAIL": "1", "RESUNETA_DENSE_TRUNK": "1",
       "RESUNETA_DENSEMM_INTERPRET": "1"}


@pytest.fixture(scope="module")
def tail():
    """The port's step on the dense trunk in tail mode "1", with the K1
    calls that took act = False, beside the reference's."""
    acts = []
    with pytest.MonkeyPatch.context() as mp:
        orig = convseg.bn_act_conv

        def counted(*a, act=True, **kw):
            acts.append(act)
            return orig(*a, act=act, **kw)

        mp.setattr(convseg, "bn_act_conv", counted)
        run = run_mode(ENV, {"dense_trunk": True, "dense_tail": "1"})
    run["acts"] = acts
    return run


def test_tail_step_routes_the_head_segments(tail):
    """44 trunk segments and the 5 head ones (K1 and K2 calls), 3 of the
    heads without the ReLU (seg1, Conv_6, Conv_8); the dense trunk's 12 K3
    calls each way and its K4 call (the 64 px PSP pools at k = 2 only)."""
    assert tail["counts"] == [49, 49, 12, 12, 1, 1]
    assert tail["acts"].count(False) == 3


def test_tail_reference_runs_its_dense_tail():
    """The reference under ENV traces 12 K3 calls and one K4 call in its
    train forward, as the port makes them (one jax.eval_shape trace)."""
    calls = {"K3": 0, "K4": 0}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        for mod, name, key in ((jdensemm, "dense_mm", "K3"),
                               (jpoolconv, "pool_conv", "K4")):
            def counted(*a, _f=getattr(mod, name), _k=key):
                calls[_k] += 1
                return _f(*a)
            mp.setattr(mod, name, counted)
        jmod = jm.ResUnetA(NC, img_size=PS, multitasking=True)
        # the step's weights (init traces the eval path: no K3/K4 call)
        variables = step_variables()
        calls.update(K3=0, K4=0)
        jax.eval_shape(lambda v: jmod.apply(
            v, jnp.zeros((BS, PS, PS, 3)), train=True,
            mutable=["batch_stats"]), variables)
    assert calls == {"K3": 12, "K4": 1}


def test_tail_metrics_row_matches(tail):
    check_row(tail)


def test_tail_gradients_stay_within_the_bf16_band(tail):
    check_grads(tail)


def test_tail_bn_running_statistics_match(tail):
    check_bn_running(tail)
