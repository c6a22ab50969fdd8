"""The PyTorch port's train step (resuneta_torch/train, losses.py,
metrics.py) against the JAX package's on the CPU.

The whole step at 64 px, bs 2, f32: uint8 patches and class ids through
make_device_pipeline, the multitask ResUnet-a d6 in train mode, Tanimoto on
all four heads, one Adam step, on both sides from the same seeded weights
(carried across by convert.from_flax) and the same raw batch. The JAX step
is resuneta_tpu.train.make_train_step itself, with one optax stage in
front of Adam that keeps the gradients in the optimizer state, so one
compiled step gives the metrics row, every gradient, the Adam update and
the BN running statistics. JAX's CPU routing is the NHWC configuration
without Pallas: its segments convolve f32 z with f32 taps, while the
port's run K1/K2's plain versions, which round z and the taps to bf16. The
tolerances below are set by that (stated at each test).

Then the losses, metrics and optimizers alone, against the JAX package and
optax, to 1e-6 relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from resuneta_torch import convert, losses, metrics
from resuneta_torch import models as tm
from resuneta_torch.data import make_device_pipeline
from resuneta_torch.ops import boundary, convseg, distance
from resuneta_torch.train import (METRICS_MULTITASK, create_train_state,
                                  make_eval_step, make_train_step)
from resuneta_tpu import losses as jlosses
from resuneta_tpu import metrics as jmetrics
from resuneta_tpu.data import make_device_pipeline as jmake_device_pipeline
from resuneta_tpu.models import resuneta as jm
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train.state import TrainState as JTrainState
from test_torch_labels import voronoi_ids
from test_torch_model import flax_variables

PS, BS, NC, LR = 64, 2, 5, 1e-4
HEADS = ("seg", "bound", "dist", "color")
WEIGHTS = {h: 1.0 for h in HEADS}


def _raw_batch(seed=11):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (BS, PS, PS, 3), dtype=np.uint8),
            "label_ids": voronoi_ids(BS, PS, NC, seed).astype(np.uint8),
            "aug": np.array([2, 1], np.int32)}


def _stash():
    """An optax stage that passes the gradients on and keeps them as its
    state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@functools.cache
def step_variables():
    """The step's seeded reference weights, once a process: the train-step
    files (this one, _dense, _modes, _tail) share them, and tracing Flax's
    init is most of their cost. The reference's RESUNETA_* switches change
    no variable (init traces the eval path). Read-only: every user copies
    what it changes."""
    jmod = jm.ResUnetA(NC, img_size=PS, multitasking=True)
    variables = flax_variables(jmod, [jnp.zeros((1, PS, PS, 3))], seed=3)
    for a in jax.tree.leaves(variables):
        a.setflags(write=False)
    return variables


@functools.cache
def _jax_step():
    """The reference step, once: JAX variables, raw batch, new state, row."""
    jmod = jm.ResUnetA(NC, img_size=PS, multitasking=True)
    variables = step_variables()
    raw = _raw_batch()
    tx = optax.chain(_stash(), optax.adam(LR, b1=0.9))
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32),
                         params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), tx=tx,
                         apply_fn=jmod.apply)
    jstep = jmake_train_step(jlosses.make_losses("tanimoto"), WEIGHTS, True,
                             preprocess=jmake_device_pipeline(NC, 1),
                             donate=False)
    jnew, jrow = jstep(jstate, {k: jnp.asarray(v) for k, v in raw.items()})
    return variables, raw, jnew, np.asarray(jrow)


def run_steps():
    """One train step on each side from the same weights and batch."""
    variables, raw, jnew, jrow = _jax_step()
    model = tm.ResUnetA(NC, img_size=PS, multitasking=True, device="cpu")
    model.load_state_dict(convert.from_flax(variables, model), strict=True)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, "adam", LR)
    step = make_train_step(losses.make_losses("tanimoto"), WEIGHTS, True,
                           preprocess=make_device_pipeline(NC, 1,
                                                           device="cpu"),
                           device="cpu")
    counts = [m.CALLS for m in (convseg, distance, boundary)] + \
        [convseg.BWD_CALLS]
    state, row = step(state, raw)
    counts = [m.CALLS - c for m, c in zip((convseg, distance, boundary),
                                          counts)] + \
        [convseg.BWD_CALLS - counts[3]]
    return {"variables": variables, "jnew": jnew, "jrow": jrow,
            "model": model, "state": state, "row": row.numpy(),
            "before": before, "counts": counts, "raw": raw}


@pytest.fixture(scope="module")
def steps():
    """The slice's path: the 44 segments fused (K1/K2 plain versions)."""
    return run_steps()


@pytest.fixture(scope="module")
def steps_unfused():
    """The same step with the segment gate off, so every segment is the
    closed-form BN apply -> f32 conv, as on JAX's CPU path: this holds the
    rest of the step (BN statistics and their gradients, PSP, heads,
    losses, optimizer) to the reference without bf16 in between."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convseg, "available", lambda *a, **k: False)
        return run_steps()


def test_step_runs_the_slice_path(steps, steps_unfused):
    """44 fused segments forward (K1) and backward (K2), and one K5 and
    one K6 call for the batch's 10 class planes; none fused with the gate
    off."""
    assert steps["counts"] == [44, 1, 1, 44]
    assert steps_unfused["counts"] == [0, 1, 1, 0]
    assert steps["state"].step == 1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_metrics_row_matches(fused, steps, steps_unfused):
    """Losses within 2e-3 relative (the reference's loss tolerance,
    tests/test_train_parity.py:181; observed ~1e-5 fused, ~1e-7 unfused).
    Accuracy and the threshold counts may differ where a probability sits
    at the threshold or two classes tie within that noise: at most 0.2% of
    the pixels."""
    run = steps if fused else steps_unfused
    got, want = run["row"], run["jrow"]
    assert got.shape == want.shape == (len(METRICS_MULTITASK),)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:5], want[:5], rtol=2e-3)
    assert abs(got[5] - want[5]) <= 2e-3
    n = BS * PS * PS * NC
    np.testing.assert_allclose(got[6:], want[6:], rtol=0, atol=2e-3 * n)
    np.testing.assert_allclose(got[0], got[1:5].sum(), rtol=1e-6)


def _grad_err(a, b, atol=1e-6):
    """Relative L2 with an absolute floor (tests/test_train_parity.py:
    113-120): a conv bias straight before a BN has a zero gradient, and
    both sides give ~1e-9 noise there."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.linalg.norm(a - b)
    return 0.0 if d <= atol else d / max(np.linalg.norm(b), 1e-12)


def _grads(run):
    want = convert.from_flax({"params": run["jnew"].opt_state[0]})
    got = {k: p.grad for k, p in run["model"].named_parameters()}
    assert sorted(got) == sorted(want)
    return got, want


def test_every_gradient_matches_unfused(steps_unfused):
    """Every parameter's gradient within 3e-2 relative L2 (the reference's
    worst-layer bound against Keras, tests/test_train_parity.py:193;
    observed 6.6e-3), through convert.from_flax of the gradient tree."""
    got, want = _grads(steps_unfused)
    errs = {k: _grad_err(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] < 3e-2, (worst, errs[worst])


def test_fused_gradients_stay_within_the_bf16_band(steps):
    """With the segments fused, the port's z and taps are bf16 and JAX's
    CPU path's are f32. That changes the gradients far more than the loss:
    at random init the deep layers' gradients are ~100x smaller than the
    heads' (the BN backward projects most of the incoming gradient away),
    so the rounding is amplified there. Measured per-layer error: 1e-3 at
    the heads, up to 0.4 at ResBlockA_4/5; against the JAX package with its
    own Pallas segments in interpret mode (also bf16) up to 0.22. The test
    holds what stays well defined: every gradient over all parameters at
    once within 0.1 relative L2 (observed 0.039), and the heads, which no
    segment precedes in the backward, within 3e-2."""
    got, want = _grads(steps)
    a = np.concatenate([got[k].numpy().ravel() for k in want])
    b = np.concatenate([want[k].numpy().ravel() for k in want])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.1
    heads = [k for k in want if k.split(".")[0] in
             ("seg1", "seg2", "seg3", "Conv_6", "Conv_7", "Conv_9",
              "Conv_10", "Conv_11")]
    assert len(heads) == 16
    worst = max(_grad_err(got[k].numpy(), want[k].numpy()) for k in heads)
    assert worst < 3e-2, worst


def test_adam_update_matches_unfused(steps_unfused):
    """The first Adam update is about lr*sign(g): elements whose gradient
    sits at the noise floor flip sign between the two sides
    (tests/test_train_parity.py:254-275). Flips below 1% of the elements,
    the rest within 0.1 relative L2. A conv bias straight before a BN has a
    zero gradient (~1e-9 of noise on both sides, against Adam's eps of
    1e-8), so its update is noise on both sides: those only move by at
    most lr."""
    jparams = convert.from_flax({"params": steps_unfused["jnew"].params})
    p0 = convert.from_flax({"params": steps_unfused["variables"]["params"]})
    jgrads = _grads(steps_unfused)[1]
    now = steps_unfused["model"].state_dict()
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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bn_running_statistics_match(fused, steps, steps_unfused):
    """0.99 * running + 0.01 * batch with the biased variance, every BN
    (the shared first BNs of a ResBlock each update their own): within
    5e-3 relative L2 (tests/test_train_parity.py:285)."""
    run = steps if fused else steps_unfused
    want = convert.from_flax({"batch_stats": run["jnew"].batch_stats})
    now = run["model"].state_dict()
    worst = max(_grad_err(now[k].numpy(), v.numpy(), atol=0)
                for k, v in want.items())
    assert worst < 5e-3, worst
    moved = [k for k in want if not torch.equal(now[k], run["before"][k])]
    assert len(moved) == len(want)


def test_eval_step_uses_the_running_statistics(steps):
    """make_eval_step after the train step: the eval forward (held against
    the Flax model in tests/test_torch_model.py) under the same losses and
    metrics, and no buffer or parameter moves."""
    raw = _raw_batch(seed=12)
    model = steps["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = make_eval_step(losses.make_losses("tanimoto"), WEIGHTS, True,
                         preprocess=make_device_pipeline(NC, 1, device="cpu"),
                         device="cpu")(steps["state"], raw).numpy()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    batch = make_device_pipeline(NC, 1, device="cpu")(raw)
    with torch.no_grad():
        out = model.eval()(batch["image"])
    fns = losses.make_losses("tanimoto")
    want = [fns[h](batch[h], out[h]).item() for h in HEADS]
    np.testing.assert_allclose(got[1:5], want, rtol=1e-6)
    np.testing.assert_allclose(got[0], sum(want), rtol=1e-6)
    assert got[5] == metrics.categorical_accuracy(batch["seg"],
                                                  out["seg"]).item()


# ------------------------------------------------------ losses, metrics

def _heads(seed, zero_class=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, NC - 1 if zero_class else NC, (3, 16, 16))
    label = np.eye(NC, dtype=np.float32)[ids]        # class NC-1 absent
    logits = rng.standard_normal((3, 16, 16, NC)).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return label, pred


@pytest.mark.parametrize("name", ["tanimoto", "cross_entropy",
                                  "weighted_cross_entropy"])
def test_losses_match_jax(name):
    """Each head's loss and its gradient with respect to the predictions,
    1e-6 relative; the seg label has a class of zero volume, so Tanimoto's
    inf weight goes to the largest finite one."""
    label, pred = _heads(1)
    ours, ref = losses.make_losses(name), jlosses.make_losses(name)
    for head in HEADS:
        lab = label if head != "color" else label[..., :3]
        prd = pred if head != "color" else pred[..., :3]
        p = torch.from_numpy(prd).requires_grad_()
        got = ours[head](torch.from_numpy(lab), p)
        (g,) = torch.autograd.grad(got, p)
        want, wg = jax.value_and_grad(lambda q: ref[head](jnp.asarray(lab),
                                                          q))(jnp.asarray(prd))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(wg).max()))


def test_tanimoto_inf_weight_takes_the_largest_finite():
    label, pred = _heads(2)
    got = losses.tanimoto_loss(torch.from_numpy(label), torch.from_numpy(pred))
    want = jlosses.tanimoto_loss(jnp.asarray(label), jnp.asarray(pred))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_device_metrics_match_jax():
    label, pred = _heads(3, zero_class=False)
    pred[0, 0, 0] = [0.5, 0.5, 0.0, 0.0, 0.0]     # a tie: the first wins
    t, p = torch.from_numpy(label), torch.from_numpy(pred)
    # the mean of 768 flags, summed in another order: within an f32 ulp
    assert metrics.categorical_accuracy(t, p).item() == pytest.approx(
        float(jmetrics.categorical_accuracy(jnp.asarray(label),
                                            jnp.asarray(pred))), rel=1.2e-7)
    got = [c.item() for c in metrics.binary_counts(t, p)]
    want = [float(c) for c in jmetrics.binary_counts(jnp.asarray(label),
                                                     jnp.asarray(pred))]
    assert got == want
    np.testing.assert_allclose(
        metrics.compute_mcc(*got).item(),
        float(jmetrics.compute_mcc(*map(jnp.float32, want))), rtol=1e-6)
    assert metrics.compute_mcc(0.0, 5.0, 0.0, 0.0).item() == 0.0


# ----------------------------------------------------------- optimizers

@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_steps_match_optax(name):
    """Three steps of each optimizer on a small tree from the same
    gradients: within 1e-6 relative of optax (the reference's
    make_optimizer: adam b1 0.9, eps 1e-8 outside the sqrt; sgd momentum
    0.8, first buffer = g)."""
    rng = np.random.default_rng(5)
    shapes = [(3, 3, 8, 8), (8,), (32,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** e
              for s, e in zip(shapes, (-1, -4, -6))] for _ in range(3)]
    lr = 1e-3
    module = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(p))
                                     for p in params])
    state = create_train_state(module, name, lr)
    tx = (optax.adam(lr, b1=0.9) if name == "adam"
          else optax.sgd(lr, momentum=0.8))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    for gs in grads:
        for prm, g in zip(module, gs):
            prm.grad = torch.from_numpy(g)
        state.optimizer.step()
        upd, opt_state = tx.update([jnp.asarray(g) for g in gs], opt_state, jp)
        jp = optax.apply_updates(jp, upd)
    # the updates, read as differences of f32 parameters of magnitude up
    # to ~4: within 2 ulps of those (1e-6)
    for prm, want, p0 in zip(module, jp, params):
        np.testing.assert_allclose(prm.detach().numpy() - p0,
                                   np.asarray(want) - p0, rtol=1e-5,
                                   atol=1e-6)
    assert state.learning_rate == lr
    assert state.override_learning_rate(5e-4).learning_rate == 5e-4


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(losses.make_losses("tanimoto"), {}, True)
    with pytest.raises(RuntimeError, match="cuda"):
        make_device_pipeline(NC)
