"""The PyTorch port's ResUnet-a (resuneta_torch/models) against the Flax
model (resuneta_tpu/models) in eval, with the same weights carried across by
resuneta_torch.convert.from_flax.

Weights are random but nontrivial (numpy-seeded: glorot-uniform kernels,
small biases, BN scale in [0.8, 1.2], running mean ~ N(0, 0.1), running var
in [0.5, 1.5]), filled into the tree that `jax.eval_shape` of Flax's init
describes, so no Flax init is compiled.

On the JAX side the K1 segments run the Pallas kernel in interpret mode: the
availability gate is patched to the port's shape predicate (the reference's
eval gate without its TPU backend check) and `bn_act_conv_pallas` to
interpret=True, in the test only. Both sides then round z and the taps to
bf16 inside K1 and run every other conv in f32."""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch import convert
from resuneta_torch import models as tm
from resuneta_torch.ops import convseg
from resuneta_tpu.models import resuneta as jm
from resuneta_tpu.ops.pallas import convseg as jconvseg


def random_variables(shapes, seed):
    """Fill an eval_shape tree of Flax variables with seeded values."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(shapes, sep="/")
    out = {}
    for key in sorted(flat):
        shape = flat[key].shape
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            rf = int(np.prod(shape[:-2]))
            lim = np.sqrt(6.0 / (shape[-2] * rf + shape[-1] * rf))
            v = rng.uniform(-lim, lim, shape)
        elif leaf == "bias":
            v = rng.standard_normal(shape) * 0.05
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "mean":
            v = rng.standard_normal(shape) * 0.1
        else:  # var
            v = rng.uniform(0.5, 1.5, shape)
        out[key] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out, sep="/")


def flax_variables(module, x, seed):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *x, train=False))
    return random_variables(flax.core.unfreeze(shapes), seed)


def _jax_k1(monkeypatch, wide):
    calls = []
    orig = jconvseg.bn_act_conv_pallas

    def available(H, W, C, Cout, d, bwd=True):
        return (convseg.available(W, C, Cout, bwd=bwd, wide=wide)
                and jconvseg._plan_tile(H, W, C, d, bwd=bwd) is not None)

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return functools.partial(orig, interpret=True)(*args, **kw)

    monkeypatch.setattr(jconvseg, "pallas_available", available)
    monkeypatch.setattr(jconvseg, "bn_act_conv_pallas", counted)
    return calls


@pytest.fixture
def jax_k1(monkeypatch):
    """Route the JAX eval segments through the Pallas kernel (interpret
    mode) under the port's predicate; count the segments routed."""
    return _jax_k1(monkeypatch, wide=False)


@pytest.fixture
def jax_k1_wide(monkeypatch):
    """The same with the wide tier on, as RESUNETA_CONVSEG_FWD_WIDE=1
    turns it on in the reference (the port's fwd_wide)."""
    monkeypatch.setenv("RESUNETA_CONVSEG_FWD_WIDE", "1")
    return _jax_k1(monkeypatch, wide=True)


def nchw(x):
    """NHWC numpy -> the port's internal NCHW (channels_last) tensor."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def load(module, variables):
    module.load_state_dict(convert.from_flax(variables, module), strict=True)
    return module.eval()


# ---------------------------------------------------------------- modules

MODULE_CASES = {
    # name: (flax module, port module, NHWC input shapes)
    "ResBlockA_32": (lambda: jm.ResBlockA(32, [1, 3, 15, 31]),
                     lambda: tm.ResBlockA(32, [1, 3, 15, 31]),
                     [(2, 32, 32, 32)]),
    "ResBlockA_128": (lambda: jm.ResBlockA(128, [1, 3, 15]),
                      lambda: tm.ResBlockA(128, [1, 3, 15]),
                      [(2, 16, 16, 128)]),
    "ResBlockA_256": (lambda: jm.ResBlockA(256, [1, 3]),
                      lambda: tm.ResBlockA(256, [1, 3]),
                      [(1, 8, 8, 256)]),
    "PSPPooling": (lambda: jm.PSPPooling(32, 256, act=True),
                   lambda: tm.PSPPooling(32, 256, act=True),
                   [(2, 16, 16, 32)]),
    "Combine": (lambda: jm.Combine(64),
                lambda: tm.Combine(32, 64, 64),
                [(2, 16, 16, 32), (2, 16, 16, 64)]),
    "UpSampleConv": (lambda: jm.UpSampleConv(64),
                     lambda: tm.UpSampleConv(128, 64),
                     [(2, 8, 8, 128)]),
}


@pytest.mark.parametrize("name", sorted(MODULE_CASES))
def test_module_eval_matches_flax(name, jax_k1):
    """Tolerance 1e-3 abs on f32 outputs of magnitude ~1-10: the same bf16
    roundings on both sides, f32 sums in another order; where a second
    segment's input differs in its last bits, a rare one-ulp bf16 flip of
    its z costs ~1e-4 at these weight scales."""
    make_j, make_t, shapes = MODULE_CASES[name]
    rng = np.random.default_rng(len(name))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jmod = make_j()
    variables = flax_variables(jmod, [jnp.asarray(x) for x in xs], seed=11)
    jax_k1.clear()      # count the apply's segments, not init's
    want = np.asarray(jmod.apply(variables, *map(jnp.asarray, xs),
                                 train=False))
    tmod = load(make_t(), variables)
    calls = convseg.CALLS
    with torch.inference_mode():
        got = nhwc(tmod(*map(nchw, xs)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert convseg.CALLS - calls == len(jax_k1)
    if name == "PSPPooling":
        assert tmod.levels == [1, 2, 4, 8]


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("multitask", [True, False],
                         ids=["multitask", "single_task"])
def test_resuneta_eval_forward_matches_flax(multitask, jax_k1):
    """64 px, N=1, 44 K1 segments on each side. Every head's probabilities
    within 5e-3 abs: the two sides' f32 activations differ in the last bits
    (other sum orders), so now and then an element of z rounds to the other
    bf16 neighbour inside K1, and random weights carry that to ~2e-3. The
    seg argmax agrees on >= 99.9% of the pixels whose reference top two
    probabilities are more than that tolerance apart; closer ones are ties
    within it. Random weights give soft outputs, so the test also holds
    that such pixels are >= 90% of the patch."""
    x = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    jmod = jm.ResUnetA(5, img_size=64, multitasking=multitask)
    variables = flax_variables(jmod, [jnp.asarray(x)], seed=21)
    jax_k1.clear()      # count the apply's segments, not init's
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    assert len(jax_k1) == 44

    tmod = tm.ResUnetA(5, img_size=64, multitasking=multitask, device="cpu")
    load(tmod, variables)
    calls = convseg.CALLS
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    assert convseg.CALLS - calls == 44

    if not multitask:
        want, got = {"seg": want}, {"seg": got}
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3, err_msg=k)
    ref = np.asarray(want["seg"])
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 5e-3
    assert decided.mean() >= 0.9
    same = np.argmax(got["seg"].numpy(), -1) == np.argmax(ref, -1)
    assert same[decided].mean() >= 0.999


def test_resuneta_eval_forward_wide_matches_flax(jax_k1_wide):
    """fwd_wide: the eval segments of RB(256) and RB(512) through K1 too, 60
    a forward in the port. At 64 px the reference's planner admits RB(256)
    at 8x8 (56 Pallas segments) but finds no plan for RB(512) at 4x4 and
    runs XLA's conv there, in f32; the port, without the plan check, runs
    K1 (z and taps in bf16). Every head's probabilities within the 5e-3 of
    the default forward's test."""
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    jmod = jm.ResUnetA(5, img_size=64)
    variables = flax_variables(jmod, [jnp.asarray(x)], seed=22)
    jax_k1_wide.clear()
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    assert len(jax_k1_wide) == 56

    tmod = load(tm.ResUnetA(5, img_size=64, device="cpu", fwd_wide=True),
                variables)
    calls = convseg.CALLS
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    assert convseg.CALLS - calls == 60
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=5e-3, err_msg=k)


# ------------------------------------------------------------- conversion

@pytest.mark.parametrize("ps,n_params,n_stats", [(64, 41_657_746, 26_688),
                                                 (256, 42_708_930, 27_744)])
def test_from_flax_maps_every_variable(ps, n_params, n_stats):
    """Every Flax variable lands on exactly one port tensor and back; the
    counts are Flax's (params, then BN running statistics)."""
    jmod = jm.ResUnetA(5, img_size=ps)
    variables = flax_variables(jmod, [jnp.zeros((1, ps, ps, 3))], seed=ps)
    flat = convert.flatten(variables)
    assert sum(v.size for k, v in flat.items()
               if k.startswith("params/")) == n_params
    assert sum(v.size for k, v in flat.items()
               if k.startswith("batch_stats/")) == n_stats

    tmod = tm.ResUnetA(5, img_size=ps, device="cpu")
    assert sum(p.numel() for p in tmod.parameters()) == n_params
    assert sum(b.numel() for b in tmod.buffers()) == n_stats
    sd = convert.from_flax(variables, tmod)
    tmod.load_state_dict(sd, strict=True)

    # invert the mapping: every port tensor back to its Flax path and value
    inverse = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
               "scale": ("params", "scale"),
               "mean": ("batch_stats", "mean"), "var": ("batch_stats", "var")}
    back = {}
    for name, t in tmod.state_dict().items():
        *path, leaf = name.split(".")
        coll, fleaf = inverse[leaf]
        v = t.numpy()
        back["/".join([coll, *path, fleaf])] = \
            v.transpose(2, 3, 1, 0) if leaf == "weight" else v
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_from_flax_rejects_unmatched_keys():
    tmod = tm.ResUnetA(5, img_size=64, multitasking=False, device="cpu")
    flat = {f"params/{k.replace('.', '/')}": v.numpy()
            for k, v in tmod.state_dict().items()
            if not k.endswith(("mean", "var"))}
    flat = {k.replace("/weight", "/kernel"): v for k, v in flat.items()}
    with pytest.raises(ValueError, match="missing"):
        convert.from_flax(flat, tmod)          # no batch_stats
    with pytest.raises(ValueError, match="unknown"):
        convert.from_flax({"params/Conv_0/gamma": np.zeros(3)})
    extra = dict(flat)
    extra["params/Conv_99/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unused"):
        convert.from_flax(extra, tmod)


def test_default_init_follows_the_reference_scheme():
    """Seeded generator, glorot-uniform convs, zero bias, BN 1/0/0/1."""
    g = torch.Generator().manual_seed(3)
    a = tm.ResUnetA(5, img_size=64, generator=g, device="cpu")
    b = tm.ResUnetA(5, img_size=64, generator=torch.Generator().manual_seed(3),
                    device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.ResBlockA_2.Conv_0.weight         # (128, 128, 3, 3)
    lim = np.sqrt(6.0 / (128 * 9 * 2))
    assert w.abs().max() <= lim and w.abs().max() > 0.9 * lim
    assert torch.count_nonzero(a.ResBlockA_2.Conv_0.bias) == 0
    bn = a.ResBlockA_2.BatchNorm_0
    assert torch.all(bn.scale == 1) and torch.all(bn.bias == 0)
    assert torch.all(bn.mean == 0) and torch.all(bn.var == 1)


# -------------------------------------------------------------- batch norm

def test_batch_norm_eval_matches_flax():
    """The eval affine a = γ·rsqrt(var+eps), b = β − mean·γ·rsqrt(var+eps)
    and the BN(+ReLU) apply, against the Flax module and fused_bn."""
    from resuneta_tpu.models.norm import BatchNorm as JBatchNorm
    from resuneta_tpu.ops import fused_bn as jfused
    from resuneta_torch.ops import fused_bn

    x = np.random.default_rng(2).standard_normal((2, 8, 8, 32)).astype(
        np.float32)
    jbn = JBatchNorm(act=True)
    variables = flax_variables(jbn, [jnp.asarray(x)], seed=4)
    want = np.asarray(jbn.apply(variables, jnp.asarray(x), train=False))
    want_a, want_b = (np.asarray(t) for t in jbn.apply(
        variables, jnp.asarray(x), train=False, return_affine=True))

    bn = load(tm.BatchNorm(32, act=True), variables)
    a, b = (t.detach() for t in bn.affine())
    np.testing.assert_allclose(a.numpy(), want_a, rtol=1e-6, atol=0)
    np.testing.assert_allclose(b.numpy(), want_b, rtol=1e-6, atol=1e-7)
    with torch.inference_mode():
        got = nhwc(bn(nchw(x)))
    # XLA fuses x*a + b into one multiply-add; PyTorch rounds twice
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert bn.momentum == 0.99 and bn.epsilon == 1e-3

    p, s = variables["params"], variables["batch_stats"]
    args = [torch.from_numpy(np.asarray(v)) for v in
            (p["scale"], p["bias"], s["mean"], s["var"])]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got16 = fused_bn.batch_norm_act(xb, *args, relu=False)
    want16 = jfused.batch_norm_act(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (
            p["scale"], p["bias"], s["mean"], s["var"])), relu=False)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_checkpoint_tool_flattens_an_orbax_checkpoint(tmp_path):
    """tools/flax_ckpt_to_npz.py: an orbax checkpoint of the JAX package
    becomes the flat .npz that restore_variables converts on load."""
    import importlib.util
    import types

    from resuneta_tpu.train import checkpoint as jckpt
    from resuneta_torch.train.checkpoint import restore_variables

    variables = {"params": {"Conv_0": {
        "kernel": np.arange(2 * 3 * 4 * 8, dtype=np.float32).reshape(
            2, 3, 4, 8), "bias": np.ones(8, np.float32)},
        "BatchNorm_0": {"scale": np.full(8, 2.0, np.float32),
                        "bias": np.zeros(8, np.float32)}},
        "batch_stats": {"BatchNorm_0": {"mean": np.zeros(8, np.float32),
                                        "var": np.ones(8, np.float32)}}}
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state={}, step=0)
    ckpt = str(tmp_path / "best_model.ckpt")
    jckpt.save_best(ckpt, state, epoch=0, min_loss=0.0)

    spec = importlib.util.spec_from_file_location(
        "flax_ckpt_to_npz", convert.__file__.replace(
            "resuneta_torch/convert.py", "tools/flax_ckpt_to_npz.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "w.npz")
    tool.main(["--model_path", ckpt, "--out", out])

    sd = restore_variables(out)
    assert sorted(sd) == ["BatchNorm_0.bias", "BatchNorm_0.mean",
                          "BatchNorm_0.scale", "BatchNorm_0.var",
                          "Conv_0.bias", "Conv_0.weight"]
    np.testing.assert_array_equal(
        sd["Conv_0.weight"].numpy(),
        variables["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
