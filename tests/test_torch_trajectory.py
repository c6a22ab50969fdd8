"""The bf16 trajectory gate's workload on the CPU
(resuneta_torch/utils/trajectory.py) and the device-time reader
(resuneta_torch/utils/xprof.py).

- The port's CPU f32 series re-derives its pin within rtol 1e-4, as
  tests/test_train.py:263-273 holds the JAX package's pin.
- With the JAX package's PRNGKey(0) initial state carried across
  (convert.from_flax; only JAX's init runs, jitted, which gives
  create_train_state's values), the port's five losses are JAX's pinned
  REFERENCE_LOSSES within rtol 2e-4 (5.1e-5 measured on the CPU).
- xprof: a CPU capture holds no device event and returns None; a step that
  raises, raises through it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch import convert
from resuneta_torch.utils import trajectory, xprof
from resuneta_tpu.models import ResUnetA as JResUnetA
from resuneta_tpu.ops.pallas import convseg as jconvseg
from resuneta_tpu.utils import trajectory as jtrajectory
from util_torch import one_thread  # noqa: F401  (fixture)


def test_cpu_f32_series_matches_pin(one_thread):
    losses = trajectory.run_losses(device="cpu")
    np.testing.assert_allclose(losses, trajectory.REFERENCE_LOSSES,
                               rtol=1e-4)
    assert trajectory.check(losses)


def test_jax_init_reproduces_the_jax_pin(one_thread):
    """The workload is the reference's: its batches in its order, the
    pipeline, Tanimoto, Adam at LR; from JAX's own init the port's steps
    give JAX's pinned series."""
    jmod = JResUnetA(num_classes=trajectory.NC, img_size=trajectory.PS,
                     multitasking=True)
    with jconvseg.disabled():     # as create_train_state inits
        v = jax.jit(lambda k: jmod.init(k, jnp.zeros(
            (1, trajectory.PS, trajectory.PS, 3), jnp.float32),
            train=False))(jax.random.PRNGKey(0))
    params = convert.from_flax({"params": jax.device_get(v["params"]),
                                "batch_stats": jax.device_get(
                                    v["batch_stats"])})
    losses = trajectory.run_losses(device="cpu", params=params)
    np.testing.assert_allclose(losses, jtrajectory.REFERENCE_LOSSES,
                               rtol=2e-4)
    assert (trajectory.N_STEPS, trajectory.PS, trajectory.BS,
            trajectory.NC, trajectory.LR, trajectory.BAND) == \
        (jtrajectory.N_STEPS, jtrajectory.PS, jtrajectory.BS,
         jtrajectory.NC, jtrajectory.LR, jtrajectory.BAND)


def test_check_holds_the_band():
    ref = np.asarray(trajectory.REFERENCE_LOSSES)
    assert trajectory.check(list(ref * 1.049))
    assert not trajectory.check(list(ref * np.array([1, 1, 1.06, 1, 1])))
    assert not trajectory.check(list(ref[:4]))


def test_xprof_cpu_capture_is_none():
    """No device events in a CPU profile: None, as the reference returns
    without a TPU plane; the thunk ran n_steps times and sync once."""
    calls = []
    x = torch.ones(64, 64)
    ms = xprof.capture_device_ms(lambda: calls.append((x @ x).sum()), 3,
                                 lambda: calls.append("sync"))
    assert ms is None
    assert len(calls) == 4 and calls[-1] == "sync"


def test_xprof_propagates_a_failing_step():
    def boom():
        raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        xprof.capture_device_ms(boom, 2, lambda: None)
