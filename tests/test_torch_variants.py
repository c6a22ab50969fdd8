"""The port's historical model family (resuneta_torch/models/variants.py,
resnet50_unet.py), the legacy config and helpers (utils/config.py,
data/legacy_utils.py) against the JAX package on the CPU.

Weights are the seeded random Flax variables of tests/test_torch_model.py
(`flax_variables`: jax.eval_shape of the init, no compile), cached once a
process, carried across by convert.from_flax. The JAX variants compute
every segment in f32 XLA; the port runs the segments that
ops/convseg.available admits (C in {32, 64, 128}) through K1's plain
version, which rounds z and the taps to bf16, so each comparison is made
twice: with the gate on (the port's path; the tolerance of
tests/test_torch_model.py) and with it off (every segment the f32 BN apply
-> conv, as JAX's; 1e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from resuneta_torch import convert, losses
from resuneta_torch import models as tm
from resuneta_torch.data import legacy_utils
from resuneta_torch.ops import convseg
from resuneta_torch.train import create_train_state, make_train_step
from resuneta_torch.utils.config import UnetConfig
from resuneta_tpu import losses as jlosses
from resuneta_tpu.data import legacy_utils as jlegacy
from resuneta_tpu.models import ResNet50UNet, ResUnetALegacy, ResUnetAV1
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train.state import TrainState as JTrainState
from resuneta_tpu.utils.config import UnetConfig as JUnetConfig
from test_torch_labels import voronoi_ids
from test_torch_model import flax_variables

# name: (Flax module, port module, NHWC input shape, K1 segments a forward)
CASES = {
    "v1_multitask": (lambda: ResUnetAV1(5, 64, True),
                     lambda: tm.ResUnetAV1(5, 64, True, device="cpu"),
                     (1, 64, 64, 3), 44),
    "v1_single_task": (lambda: ResUnetAV1(5, 64, False),
                       lambda: tm.ResUnetAV1(5, 64, False, device="cpu"),
                       (1, 64, 64, 3), 44),
    "legacy_64": (lambda: ResUnetALegacy(5, 64),
                  lambda: tm.ResUnetALegacy(5, 64, device="cpu"),
                  (1, 64, 64, 3), 32),
    # the 128 px build takes 128 px input (its depth follows the size)
    "legacy_128": (lambda: ResUnetALegacy(5, 128),
                   lambda: tm.ResUnetALegacy(5, 128, device="cpu"),
                   (1, 128, 128, 3), 44),
    "resnet50_unet": (lambda: ResNet50UNet(3),
                      lambda: tm.ResNet50UNet(3, in_channels=14,
                                              device="cpu"),
                      (1, 64, 64, 14), 0),
}


@functools.cache
def _reference(name):
    """The seeded Flax variables, the input and JAX's eval forward of a
    case, once a process (read-only)."""
    make_j, _, shape, _ = CASES[name]
    x = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    jmod = make_j()
    variables = flax_variables(jmod, [jnp.asarray(x)], seed=21)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in want.items()} \
        if isinstance(want, dict) else {"seg": np.asarray(want)}
    return variables, x, want


def _port(name, variables):
    tmod = CASES[name][1]()
    tmod.load_state_dict(convert.from_flax(variables, tmod), strict=True)
    return tmod.eval()


@pytest.mark.parametrize("multitask,expected",
                         [(True, 42_196_290), (False, 42_149_621)])
def test_v1_param_count(multitask, expected):
    """tests/test_model_variants.py:21-26: Keras' count_params of
    ResUnet_a/model.py at 64 px, BN statistics included."""
    m = tm.ResUnetAV1(5, img_size=64, multitasking=multitask, device="cpu")
    assert sum(p.numel() for p in m.parameters()) + \
        sum(b.numel() for b in m.buffers()) == expected


@pytest.mark.parametrize("name", sorted(CASES))
def test_from_flax_maps_every_variable(name):
    """Every Flax variable lands on one port tensor of its shape, and the
    counts agree (convert.from_flax with model= raises otherwise)."""
    variables = _reference(name)[0]
    flat = convert.flatten(variables)
    tmod = CASES[name][1]()
    sd = convert.from_flax(variables, tmod)
    assert sorted(sd) == sorted(tmod.state_dict())
    assert sum(v.size for v in flat.values()) == \
        sum(t.numel() for t in tmod.state_dict().values())


@pytest.mark.parametrize("gate", [True, False], ids=["k1", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_forward_matches_flax(name, gate, monkeypatch):
    """Every head within 5e-3 abs with K1's plain version on its segments
    (tests/test_torch_model.py's tolerance: bf16 z and taps against JAX's
    f32; observed up to 2.4e-3) and within 1e-5 with every segment in f32
    (observed 4.5e-7); the segments routed count as K1 calls."""
    variables, x, want = _reference(name)
    tmod = _port(name, variables)
    if not gate:
        monkeypatch.setattr(convseg, "available", lambda *a, **k: False)
    calls = convseg.CALLS
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    assert convseg.CALLS - calls == (CASES[name][3] if gate else 0)
    got = got if isinstance(got, dict) else {"seg": got}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 if gate else 1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("gate", [True, False], ids=["k1", "f32"])
def test_legacy_predict_ids_matches_jax(gate, monkeypatch):
    """model_old.py:179-185: the mean subtracted, eval forward, argmax,
    on a raw 0-255 image. With the segments in f32 the ids equal JAX's
    wherever its top two probabilities are more than 1e-5 apart (the
    forward's tolerance; closer is a tie). With K1's plain version (bf16 z
    of inputs up to ~170 in magnitude) at least 99.5% of the pixels whose
    top two are more than 5e-3 apart agree (observed 99.88%)."""
    variables = _reference("legacy_64")[0]
    jmod = CASES["legacy_64"][0]()
    img = np.random.default_rng(9).uniform(0, 255, (64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jmod.predict_ids(variables, img))
    probs = np.asarray(jmod.apply(
        variables, (jnp.asarray(img) - jnp.asarray(jmod.mean))[None],
        train=False))[0]
    if not gate:
        monkeypatch.setattr(convseg, "available", lambda *a, **k: False)
    got = _port("legacy_64", variables).predict_ids(img).numpy()
    assert got.shape == want.shape == (64, 64)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > (5e-3 if gate else 1e-5)
    assert decided.mean() > 0.9
    same = got[decided] == want[decided]
    if gate:
        assert same.mean() >= 0.995, same.mean()
    else:
        assert same.all()


# --------------------------------------------------- the legacy train step

LR, BS = 1e-3, 2


def _stash():
    """An optax stage that passes the gradients on and keeps them."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _legacy_batch():
    """A low-contrast image (pixels within ~25 of the config mean, as the
    driver feeds them: mean-subtracted) and a one-hot of Voronoi regions.
    At random init a full-range image saturates the legacy model's
    softmax (no BN after the stem's skip, the PSPs or the decoder): some
    class's probability underflows to 0 over the batch, the dual
    Tanimoto's weights from the prediction volumes turn inf and every
    gradient NaN, in JAX as in the port."""
    rng = np.random.default_rng(13)
    img = rng.normal(0.0, 8.0, (BS, 64, 64, 3)).astype(np.float32)
    ids = voronoi_ids(BS, 64, 5, 13)
    return {"image": img, "seg": np.eye(5, dtype=np.float32)[ids]}


@functools.cache
def _jax_legacy_step():
    """JAX's single-task step of the legacy driver (compat.UNet: Adam 1e-3,
    tanimoto_dual_loss on seg), once: new state and row."""
    variables = _reference("legacy_64")[0]
    jmod = CASES["legacy_64"][0]()
    tx = optax.chain(_stash(), optax.adam(LR, b1=0.9))
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32),
                         params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), tx=tx,
                         apply_fn=jmod.apply)
    jstep = jmake_train_step({"seg": jlosses.tanimoto_dual_loss}, {}, False,
                             donate=False)
    batch = _legacy_batch()
    jnew, jrow = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return jnew, np.asarray(jrow)


def _legacy_step(gate):
    variables = _reference("legacy_64")[0]
    model = _port("legacy_64", variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, "adam", LR)
    step = make_train_step({"seg": losses.tanimoto_dual_loss}, {}, False,
                           device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        if not gate:
            mp.setattr(convseg, "available", lambda *a, **k: False)
        calls = convseg.BWD_CALLS
        state, row = step(state, _legacy_batch())
        bwd_calls = convseg.BWD_CALLS - calls
    return {"model": model, "row": row.numpy(), "before": before,
            "bwd_calls": bwd_calls}


@pytest.fixture(scope="module")
def legacy_steps():
    return {gate: _legacy_step(gate) for gate in (True, False)}


def _rel(a, b, atol=1e-6):
    """Relative L2 with an absolute floor (tests/test_torch_train.py
    _grad_err)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.linalg.norm(a - b)
    return 0.0 if d <= atol else d / max(np.linalg.norm(b), 1e-12)


@pytest.mark.parametrize("gate", [True, False], ids=["k1k2", "f32"])
def test_legacy_step_row_grads_and_buffers(legacy_steps, gate):
    """One step of the legacy driver at 64 px, bs 2, at the tolerances of
    tests/test_torch_train.py's 64 px f32 step: the loss within 2e-3
    relative, the accuracy within 2e-3 and the counts within 2e-3 of the
    elements, every BN running buffer within 5e-3 relative L2 (each
    moved). With every segment in f32, as JAX's: each gradient within
    3e-2 relative L2 (floor 1e-6: a conv bias before a BN has a zero
    gradient) and all at once within 0.1 (observed 1.3e-4). With K1 + K2's
    plain versions on the 32 segments (bf16 z and taps) the gradients of
    the deep RB(1024), which no segment computes, follow the rounding of
    the shallow activations (0.24-0.26 relative each, a layer 100x
    smaller than the heads'): all at once they read 0.132 against JAX and
    the same 0.132 against the port's own f32 route, held within 0.2."""
    run = legacy_steps[gate]
    jnew, jrow = _jax_legacy_step()
    assert run["bwd_calls"] == (32 if gate else 0)
    got = run["row"]
    assert got.shape == jrow.shape == (6,)
    np.testing.assert_allclose(got[0], jrow[0], rtol=2e-3)
    assert abs(got[1] - jrow[1]) <= 2e-3
    n = BS * 64 * 64 * 5
    np.testing.assert_allclose(got[2:], jrow[2:], rtol=0, atol=2e-3 * n)

    want = convert.from_flax({"params": jnew.opt_state[0]})
    grads = {k: p.grad.numpy() for k, p in run["model"].named_parameters()}
    assert sorted(grads) == sorted(want)
    a = np.concatenate([grads[k].ravel() for k in want])
    b = np.concatenate([want[k].numpy().ravel() for k in want])
    assert _rel(a, b, atol=0) < (0.2 if gate else 0.1)
    if not gate:
        errs = {k: _rel(grads[k], want[k].numpy()) for k in want}
        worst = max(errs, key=errs.get)
        assert errs[worst] < 3e-2, (worst, errs[worst])

    stats = convert.from_flax({"batch_stats": jnew.batch_stats})
    now = run["model"].state_dict()
    worst = max(_rel(now[k].numpy(), v.numpy(), atol=0)
                for k, v in stats.items())
    assert worst < 5e-3, worst
    assert all(not torch.equal(now[k], run["before"][k]) for k in stats)


def test_legacy_adam_update_matches(legacy_steps):
    """The first Adam update (lr 1e-3) with the segments in f32: sign
    flips below 1% of the elements, the rest within 0.1 relative L2 (floor
    4e-6); a parameter whose JAX gradient is under 1e-6 (a conv bias
    before a BN) moves by at most lr (tests/test_torch_train.py)."""
    run = legacy_steps[False]
    jnew, _ = _jax_legacy_step()
    jparams = convert.from_flax({"params": jnew.params})
    p0 = convert.from_flax({"params": _reference("legacy_64")[0]["params"]})
    jgrads = convert.from_flax({"params": jnew.opt_state[0]})
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
        worst = max(worst, _rel(du_o[~flip], du_j[~flip], atol=4e-6))
    assert n_flip / n_tot < 0.01, (n_flip, n_tot)
    assert worst < 0.1, worst


# -------------------------------------------------- config and helpers

def test_unet_config_matches_jax(capsys):
    got, want = UnetConfig(), JUnetConfig()
    assert got.__dict__ == want.__dict__
    got.displayConfiguration()
    mine = capsys.readouterr().out
    want.displayConfiguration()
    assert mine == capsys.readouterr().out
    assert "CLASSES_NUM" in mine


@pytest.mark.parametrize("shape,patch,stride", [((8, 8), 4, 2),
                                                ((13, 17, 3), 5, 3),
                                                ((16, 16), 16, 1)])
def test_mask_indices_match_jax(shape, patch, stride):
    img = np.zeros(shape)
    got = legacy_utils.extract_patches_mask_indices(img, patch, stride)
    want = jlegacy.extract_patches_mask_indices(img, patch, stride)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_patches_batch_and_test_model_match_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((16, 16, 3))
    rows, cols = [5, 8, 10], [5, 8, 3]
    np.testing.assert_array_equal(
        legacy_utils.get_patches_batch(img, rows, cols, radio=2, batch=3),
        jlegacy.get_patches_batch(img, rows, cols, radio=2, batch=3))
    probs = rng.random((6, 3))
    y = rng.integers(0, 3, 6)
    for g, w in zip(legacy_utils.test_model(None, y, lambda x: probs),
                    jlegacy.test_model(None, y, lambda x: probs)):
        np.testing.assert_array_equal(g, w)
