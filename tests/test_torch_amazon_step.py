"""The port's Amazon multitask step and whole-scene prediction against the
JAX package's on the CPU.

The step of the Amazon train CLI at 64 px, bs 2, f32: the 14-band,
3-class ResUnet-a d6 without the colour head, float image batches with a
one-hot 'seg' through make_label_head_pipeline (the boundary and distance
labels made from the one-hot), the WCE loss with the pixel-count weights
on seg, bound and dist, each weighted 1.0, one Adam step. Both sides start
from the same seeded weights (convert.from_flax) and take the same batch;
the JAX step is resuneta_tpu.train.make_train_step itself with the JAX
make_label_head_pipeline, given the labels the port's pipeline made
(_labelled_batch), and test_torch_train's optax stage that keeps the
gradients. The metrics row,
every gradient, the Adam update and the BN running statistics are held at
tests/test_torch_train.py's tolerances, stated at each test (JAX's CPU
routing convolves f32 z with f32 taps; the port's fused segments run
K1/K2's plain versions, which round them to bf16, and the unfused run
turns that gate off).

Then infer/amazon.py's prediction on a 64 x 128 x 14 scene of two 64 px
patches, the chain on the port's model's outputs, bit for bit in both
packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from resuneta_torch import convert, losses
from resuneta_torch import models as tm
from resuneta_torch.data import make_label_head_pipeline
from resuneta_torch.infer import amazon as tinfer
from resuneta_torch.infer.sliding import make_apply_fn
from resuneta_torch.ops import boundary, convseg, distance
from resuneta_torch.train import create_train_state, make_train_step
from resuneta_tpu import losses as jlosses
from resuneta_tpu.data import make_label_head_pipeline as jmake_label_head
from resuneta_tpu.infer import amazon as jinfer
from resuneta_tpu.models import resuneta as jm
from resuneta_tpu.ops import morphology as jmorph
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train.state import TrainState as JTrainState
from test_torch_model import flax_variables
from test_torch_train import _grad_err, _stash

PS, BS, NC, BANDS, LR = 64, 2, 3, 14, 1e-4
HEADS = ("seg", "bound", "dist")
WEIGHTS = {h: 1.0 for h in HEADS}
# WCE weights as the preprocess CLI derives them from pixel counts
CLASS_WEIGHTS = [1.08, 13.5, 0.0]
HEAD_LEAVES = ("seg1", "seg2", "seg3", "Conv_6", "Conv_7", "Conv_9",
               "Conv_10")


def _jmodel():
    return jm.ResUnetA(NC, img_size=PS, multitasking=True, color_head=False)


@functools.cache
def _variables():
    """The seeded reference weights of the 14-band model, read-only."""
    variables = flax_variables(_jmodel(), [jnp.zeros((1, PS, PS, BANDS))],
                               seed=5)
    for a in jax.tree.leaves(variables):
        a.setflags(write=False)
    return variables


def _batch(seed=21):
    """Normalized 14-band patches and a one-hot of blob class ids with
    class 2 (not considered) in a ring, as the Amazon tiles give them."""
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((BS, PS, PS, BANDS)).astype(np.float32)
    ids = np.zeros((BS, PS, PS), np.int64)
    for b in range(BS):
        for _ in range(4):
            r0, c0 = rng.integers(0, PS - 20, 2)
            dh, dw = rng.integers(6, 18, 2)
            ids[b, r0 - 2:r0 + dh + 2, c0 - 2:c0 + dw + 2] = 2
            ids[b, r0:r0 + dh, c0:c0 + dw] = 1
    return {"image": image, "seg": np.eye(NC, dtype=np.float32)[ids]}


@functools.cache
def _labelled_batch():
    """The batch with the boundary and distance labels the port's
    make_label_head_pipeline makes. tests/test_torch_labels.py holds those
    labels bit for bit against the JAX pipeline's; the JAX step takes
    them as they are (its make_label_head_pipeline passes a batch that
    has them through), which spares it the label graphs' compile."""
    out = make_label_head_pipeline("cpu")(_batch())
    return {k: v.numpy() for k, v in out.items()}


@functools.cache
def _jax_step():
    variables = _variables()
    batch = _labelled_batch()
    tx = optax.chain(_stash(), optax.adam(LR, b1=0.9))
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32),
                         params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), tx=tx,
                         apply_fn=_jmodel().apply)
    wce = jlosses.weighted_categorical_crossentropy(CLASS_WEIGHTS)
    jstep = jmake_train_step({h: wce for h in HEADS}, WEIGHTS, True,
                             preprocess=jmake_label_head(), donate=False)
    jnew, jrow = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return jnew, np.asarray(jrow)


def _run(fused):
    jnew, jrow = _jax_step()
    with pytest.MonkeyPatch.context() as mp:
        if not fused:
            mp.setattr(convseg, "available", lambda *a, **k: False)
        model = tm.ResUnetA(NC, img_size=PS, multitasking=True,
                            color_head=False, in_channels=BANDS, device="cpu")
        model.load_state_dict(convert.from_flax(_variables(), model),
                              strict=True)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        state = create_train_state(model, "adam", LR)
        wce = losses.weighted_categorical_crossentropy(CLASS_WEIGHTS)
        step = make_train_step({h: wce for h in HEADS}, WEIGHTS, True,
                               preprocess=make_label_head_pipeline("cpu"),
                               device="cpu")
        mods = (convseg, distance, boundary)
        calls = [m.CALLS for m in mods] + [convseg.BWD_CALLS]
        state, row = step(state, _batch())
        calls = [m.CALLS - c for m, c in zip(mods, calls)] + \
            [convseg.BWD_CALLS - calls[3]]
    return {"model": model, "state": state, "row": row.numpy(),
            "before": before, "calls": calls, "jnew": jnew, "jrow": jrow}


@pytest.fixture(scope="module")
def fused():
    """The CLI's path on the CPU: the 44 segments fused (K1/K2 plain)."""
    return _run(True)


@pytest.fixture(scope="module")
def unfused():
    """The segment gate off: every segment an f32 conv, as JAX's CPU path."""
    return _run(False)


def _grads(run):
    """(the port's gradients, JAX's in the port's names), once a run."""
    if "grads" not in run:
        want = convert.from_flax({"params": run["jnew"].opt_state[0]})
        got = {k: p.grad for k, p in run["model"].named_parameters()}
        assert sorted(got) == sorted(want)
        run["grads"] = got, want
    return run["grads"]


def test_step_runs_the_amazon_path(fused, unfused):
    """44 fused segments each way, one EDT and one Canny call over the
    batch's 6 class planes; no colour head (HSV has no meaning for 14
    bands), so its loss is 0 in the row."""
    assert fused["calls"] == [44, 1, 1, 44]
    assert unfused["calls"] == [0, 1, 1, 0]
    assert fused["state"].step == 1
    assert not hasattr(fused["model"], "Conv_11")
    assert fused["model"].Conv_0.weight.shape == (32, BANDS, 1, 1)


@pytest.mark.parametrize("which", ["fused", "unfused"])
def test_metrics_row_matches(which, fused, unfused):
    """Losses within 2e-3 relative (tests/test_torch_train.py); the colour
    loss 0 on both sides; accuracy and the threshold counts within 0.2%
    of the pixels."""
    run = fused if which == "fused" else unfused
    got, want = run["row"], run["jrow"]
    assert got.shape == want.shape == (10,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:4], want[:4], rtol=2e-3)
    assert got[4] == want[4] == 0.0
    assert abs(got[5] - want[5]) <= 2e-3
    n = BS * PS * PS * NC
    np.testing.assert_allclose(got[6:], want[6:], rtol=0, atol=2e-3 * n)
    np.testing.assert_allclose(got[0], got[1:4].sum(), rtol=1e-6)


def test_every_gradient_matches_unfused(unfused):
    """Every parameter's gradient within 3e-2 relative L2, as
    tests/test_torch_train.py holds the ISPRS step's."""
    got, want = _grads(unfused)
    errs = {k: _grad_err(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] < 3e-2, (worst, errs[worst])


def test_fused_gradients_stay_within_the_bf16_band(fused):
    """bf16 z and taps in the fused segments: every gradient at once
    within 0.1 relative L2, the heads (no segment before them in the
    backward) each within 3e-2 (tests/test_torch_train.py)."""
    got, want = _grads(fused)
    a = np.concatenate([got[k].numpy().ravel() for k in want])
    b = np.concatenate([want[k].numpy().ravel() for k in want])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.1
    heads = [k for k in want if k.split(".")[0] in HEAD_LEAVES]
    assert len(heads) == 14
    worst = max(_grad_err(got[k].numpy(), want[k].numpy()) for k in heads)
    assert worst < 3e-2, worst


def test_adam_update_matches_unfused(unfused):
    """Sign flips of noise-floor gradients in under 1% of the elements,
    the rest within 0.1 relative L2; a zero-gradient bias moves at most lr
    (tests/test_torch_train.py)."""
    jparams = convert.from_flax({"params": unfused["jnew"].params})
    p0 = convert.from_flax({"params": _variables()["params"]})
    jgrads = _grads(unfused)[1]
    now = unfused["model"].state_dict()
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


@pytest.mark.parametrize("which", ["fused", "unfused"])
def test_bn_running_statistics_match(which, fused, unfused):
    """Every BN's running buffers within 5e-3 relative L2, and every one
    moved (tests/test_torch_train.py)."""
    run = fused if which == "fused" else unfused
    want = convert.from_flax({"batch_stats": run["jnew"].batch_stats})
    now = run["model"].state_dict()
    worst = max(_grad_err(now[k].numpy(), v.numpy(), atol=0)
                for k, v in want.items())
    assert worst < 5e-3, worst
    assert all(not torch.equal(now[k], run["before"][k]) for k in want)


# ------------------------------------------------- whole-scene prediction

def _scene(seed=31):
    """A 64 x 128 x 14 scene (two 64 px patches, one batch) with blobs of
    deforestation, a past reference and the right half as test tiles."""
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((PS, 2 * PS, BANDS)).astype(np.float32)
    ref = np.zeros((PS, 2 * PS), np.uint8)
    for _ in range(6):
        r0, c0 = rng.integers(0, PS - 20), rng.integers(0, 2 * PS - 20)
        dh, dw = rng.integers(4, 20, 2)
        ref[r0:r0 + dh, c0:c0 + dw] = 1
    past = (rng.uniform(size=ref.shape) < 0.02).astype(np.uint8)
    final = jmorph.mask_no_considered(ref, 2, past)
    mask_ts = np.zeros(ref.shape, np.float32)
    mask_ts[:, PS // 2:] = 1
    return image, ref, final, mask_ts


def test_prediction_matches_jax(fused):
    """The port's model (its eval path: the fused segments) through both
    packages' prediction(): its outputs given to each, every output bit
    for bit, in the light regime (ids and the f16 class-1 plane reduced on
    the device) and the full one; the forward runs once, as
    tests/test_torch_infer.py holds the sliding functions on one forward.
    The eval forward against the Flax model is tests/test_torch_model.py's
    (the 14 bands change only Conv_0's input width, which the train step
    above holds)."""
    image, ref, final, mask_ts = _scene()
    args = (image, ref, final, mask_ts, PS, 11)
    apply_fn = make_apply_fn(fused["model"], "cpu")   # after its step
    outs = {}

    def port(x):
        """The forward, once a batch."""
        key = np.asarray(x).tobytes()
        if key not in outs:
            outs[key] = apply_fn(x)
        return outs[key]

    def as_jax(x):
        return {k: jnp.asarray(v.numpy()) for k, v in port(x).items()}

    calls = convseg.CALLS
    for full in (False, True):
        got = tinfer.prediction(port, *args, batch_size=2, full_probs=full)
        want = jinfer.prediction(as_jax, *args, batch_size=2,
                                 full_probs=full)
        for g, w in zip(got[:6], want[:6]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert len(outs) == 1 and convseg.CALLS - calls == 44
    assert sorted(outs[next(iter(outs))]) == ["bound", "dist", "seg"]
