"""K3 and K4 of the PyTorch port (resuneta_torch/ops/densemm.py,
poolconv.py), the dense trunk's glue (ops/dense.py) and the dense
PSPPooling against the JAX package on the CPU.

The JAX side runs the Pallas kernels themselves in interpret mode
(densemm.dense_mm, poolconv.pool_conv with interpret=True, or the glue with
RESUNETA_DENSEMM_INTERPRET=1), forward and jax.vjp; the port runs the
kernels' plain versions, the path its wrappers take for a CPU tensor.
Inputs are drawn with numpy and handed to both. The reference works on the
(N, H, W*C) view, the port on NHWC: the same bytes, reshaped.

Tolerances: in f32 both sides compute the same f32 products and differ only
in the order of the f32 sums, 1e-5 relative with 1e-5 of the largest
magnitude. In bf16 both round the operands the same way and sum exact
products in f32, so y and dx differ by at most one bf16 ulp of the final
cast (2^-7 relative) and dW, dbias by f32 order (1e-4 of the largest
magnitude). With integer-valued x, g and W every sum is exact, and K4's
tie-split dx must equal JAX's bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch import convert
from resuneta_torch.models import resuneta as tmr
from resuneta_torch.ops import dense as dops
from resuneta_torch.ops import densemm, poolconv
from resuneta_tpu.models import resuneta as jm
from resuneta_tpu.ops import dense as jdops
from resuneta_tpu.ops.pallas import densemm as jdensemm
from resuneta_tpu.ops.pallas import poolconv as jpoolconv
from test_torch_model import flax_variables


def _close(got, want, bf16, small_rtol=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=small_rtol,
                                   atol=1e-5 * scale)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------- K3

# (N, H, W, cins, cout, acts, ups): one to five parts, the main path's
# kinds at small sizes (a plain conv, a narrow output, Combine's (dec,
# ReLU, x2) + skip, the PSP projection at 64 px, ups 8, five parts), each
# where the reference's planner admits it. It admits five parts with ups
# (1, 2, 4, 4, 1) only in bf16 and never (1, 2, 4, 8, 1): the port's fold
# of all four levels is held through the PSP module test below.
K3_CASES = [
    (2, 16, 16, (32,), 32, (False,), (1,)),
    (2, 16, 16, (32,), 8, (True,), (1,)),
    (1, 16, 16, (64, 128), 128, (True, False), (2, 1)),
    (1, 16, 32, (16, 32), 32, (True, False), (2, 1)),
    (2, 16, 32, (8, 8, 32), 32, (False, True, False), (1, 2, 1)),
    (1, 64, 128, (8,), 32, (False,), (8,)),
    (1, 64, 128, (8, 8, 8, 8, 32), 32, (False,) * 5, (1, 2, 2, 2, 1)),
    (1, 64, 128, (8, 8, 8, 8, 32), 32, (False,) * 5, (1, 2, 4, 4, 1)),
]
K3_PARAMS = [(i, dt) for i, c in enumerate(K3_CASES)
             for dt in ("float32", "bfloat16")
             if dt == "bfloat16" or c[6] != (1, 2, 4, 4, 1)]


def _k3_inputs(case, seed, dtype):
    N, H, W, cins, cout, acts, ups = case
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((N, H // k, W // k, c)).astype(np.float32)
          for c, k in zip(cins, ups)]
    w = (rng.standard_normal((sum(cins), cout)) / sum(cins) ** 0.5).astype(
        np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    g = rng.standard_normal((N, H, W, cout)).astype(np.float32)
    if dtype == "bfloat16":   # values that bf16 holds exactly on both sides
        xs = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
              for x in xs]
        g = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    return xs, w, b, g


@pytest.mark.parametrize(
    "case,dtype", K3_PARAMS,
    ids=[f"{len(K3_CASES[i][3])}parts-ups{''.join(map(str, K3_CASES[i][6]))}"
         f"-cout{K3_CASES[i][4]}-{dt}" for i, dt in K3_PARAMS])
def test_k3_plain_matches_pallas_interpret(case, dtype):
    N, H, W, cins, cout, acts, ups = K3_CASES[case]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    assert jdensemm.available(H, W, cins, cout, ups, interpret=True,
                              itemsize=2 if dtype == "bfloat16" else 4)
    xs, w, b, g = _k3_inputs(K3_CASES[case], case, dtype)
    spec = (W, cins, cout, acts, ups)
    offs = np.cumsum((0,) + cins)
    jxs = tuple(jnp.asarray(x.reshape(N, x.shape[1], -1), jdt) for x in xs)
    jws = tuple(jnp.asarray(w[offs[i]:offs[i + 1]])
                for i in range(len(cins)))
    jy, vjp = jax.vjp(lambda xs_, ws_, b_: jdensemm.dense_mm(
        spec, True, xs_, ws_, b_), jxs, jws, jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g.reshape(N, H, -1), jdt))

    tdt = getattr(torch, dtype)
    txs = [torch.from_numpy(x).to(tdt) for x in xs]
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    calls = densemm.CALLS, densemm.BWD_CALLS
    y = densemm.dense_mm_fwd(txs, tw, tb, acts=acts, ups=ups)
    dxs, dw, db = densemm.dense_mm_bwd(
        txs, torch.from_numpy(g).to(tdt), tw, acts=acts, ups=ups)
    assert (densemm.CALLS, densemm.BWD_CALLS) == (calls[0] + 1,
                                                  calls[1] + 1)
    assert y.dtype == tdt and all(d.dtype == tdt for d in dxs)
    bf16 = dtype == "bfloat16"
    _close(_np(y).reshape(N, H, -1), jy, bf16)
    for dx, jd in zip(dxs, jdx):
        _close(_np(dx).reshape(jd.shape), jd, bf16)
    # dW and dbias are f32 on both sides: f32 order only
    _close(_np(dw), np.concatenate([np.asarray(d) for d in jdw]), False,
           1e-4 if bf16 else 1e-5)
    _close(_np(db), jdb, False, 1e-4 if bf16 else 1e-5)


# ---------------------------------------------------------------- K4

# (N, H, W, C, cout, k): the smallest planes the reference's lane
# alignment admits at each k
K4_CASES = [(2, 16, 32, 32, 8, 2), (1, 32, 64, 32, 8, 4),
            (1, 64, 128, 32, 8, 8)]


def _k4_run(case, x, w, b, g, dtype):
    N, H, W, C, cout, k = case
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    assert jpoolconv.available(H, W, C, cout, k, interpret=True)
    spec = (W, C, cout, k)
    jy, vjp = jax.vjp(lambda x_, w_, b_: jpoolconv.pool_conv(
        spec, True, x_, w_, b_), jnp.asarray(x.reshape(N, H, -1), jdt),
        jnp.asarray(w), jnp.asarray(b))
    want = (jy,) + vjp(jnp.asarray(g.reshape(N, H // k, -1), jdt))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    calls = poolconv.CALLS, poolconv.BWD_CALLS
    y = poolconv.pool_conv_fwd(tx, torch.from_numpy(w), torch.from_numpy(b),
                               k=k)
    got = (y,) + poolconv.pool_conv_bwd(tx, torch.from_numpy(g).to(tdt),
                                        torch.from_numpy(w), k=k)
    assert (poolconv.CALLS, poolconv.BWD_CALLS) == (calls[0] + 1,
                                                    calls[1] + 1)
    return [_np(t) for t in got], [np.asarray(t, np.float32) for t in want]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: f"k{c[5]}")
def test_k4_plain_matches_pallas_interpret(case, dtype):
    N, H, W, C, cout, k = case
    rng = np.random.default_rng(k)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    g = rng.standard_normal((N, H // k, W // k, cout)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        g = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    w = (rng.standard_normal((C, cout)) / C ** 0.5).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    got, want = _k4_run(case, x, w, b, g, dtype)
    bf16 = dtype == "bfloat16"
    _close(got[0].reshape(want[0].shape), want[0], bf16)
    _close(got[1].reshape(want[1].shape), want[1], bf16)
    _close(got[2], want[2], False, 1e-4 if bf16 else 1e-5)
    _close(got[3], want[3], False, 1e-4 if bf16 else 1e-5)


@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: f"k{c[5]}")
def test_k4_ties_split_exactly_as_jax(case):
    """Integer-valued x, g and W: a third or more of the windows hold
    their max more than once, every sum is exact, and dx = dz / ties must
    equal JAX's bit for bit (max_pool2d's backward would give one element
    all of dz)."""
    N, H, W, C, cout, k = case
    rng = np.random.default_rng(10 + k)
    x = rng.integers(-2, 3, (N, H, W, C)).astype(np.float32)
    g = rng.integers(-3, 4, (N, H // k, W // k, cout)).astype(np.float32)
    w = rng.integers(-2, 3, (C, cout)).astype(np.float32)
    b = np.zeros(cout, np.float32)
    got, want = _k4_run(case, x, w, b, g, "float32")
    xw = x.reshape(N, H // k, k, W // k, k, C)
    ties = (xw == xw.max(axis=(2, 4), keepdims=True)).sum(axis=(2, 4))
    assert (ties > 1).mean() > 0.3
    for gt, wt in zip(got, want):
        np.testing.assert_array_equal(gt.reshape(wt.shape), wt)


# ------------------------------------------------------------ the glue

def _glue(name, rng):
    """(port function, JAX function, inputs as NHWC numpy arrays, kwargs
    shared by both) for one glue op of ops/dense.py."""
    x = rng.standard_normal((2, 16, 32, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 16)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    if name == "conv1x1":
        return (lambda x_, w_, b_: dops.conv1x1(x_, w_, b_, act_in=True),
                lambda x_, w_, b_: jdops.conv1x1(
                    x_, w_, b_, cin=32, cout=16, dtype=jnp.float32,
                    act_in=True), (x, w, b))
    if name == "downsample2_conv1x1":
        return (dops.downsample2_conv1x1,
                lambda x_, w_, b_: jdops.downsample2_conv1x1(
                    x_, w_, b_, cin=32, cout=16, dtype=jnp.float32),
                (x, w, b))
    if name == "pool_conv1x1":
        x = rng.standard_normal((1, 32, 64, 32)).astype(np.float32)
        w8 = np.ascontiguousarray(w[:, :8])
        return (lambda x_, w_, b_: dops.pool_conv1x1(x_, w_, b_, k=4),
                lambda x_, w_, b_: jdops.pool_conv1x1(
                    x_, w_, b_, cin=32, cout=8, k=4, dtype=jnp.float32),
                (x, w8, b[:8].copy()))
    if name == "concat_conv1x1":
        dec = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
        w2 = (rng.standard_normal((48, 32)) * 0.2).astype(np.float32)
        b2 = (rng.standard_normal(32) * 0.1).astype(np.float32)
        return (lambda d_, s_, w_, b_: dops.concat_conv1x1(
                    [(d_, True, 2), (s_, False, 1)], w_, b_),
                lambda d_, s_, w_, b_: jdops.concat_conv1x1(
                    [(d_, 16, True, 2), (s_, 32, False, 1)], w_, b_,
                    cout=32, dtype=jnp.float32),
                (dec, x, w2, b2))
    if name == "max_pool":
        xi = rng.integers(-2, 3, (1, 16, 16, 16)).astype(np.float32)
        return (lambda x_: dops.max_pool(x_, 4),
                lambda x_: jdops.max_pool(x_, width=16, channels=16, k=4),
                (xi,))
    assert name == "upsample_nearest"
    return (lambda x_: dops.upsample_nearest(x_, 4),
            lambda x_: jdops.upsample_nearest(x_, width=32, channels=32,
                                              k=4), (x,))


@pytest.mark.parametrize("name", ["conv1x1", "downsample2_conv1x1",
                                  "concat_conv1x1", "pool_conv1x1",
                                  "max_pool", "upsample_nearest"])
def test_glue_matches_jax_dense_ops(name, monkeypatch):
    """Each op and its gradients against resuneta_tpu/ops/dense.py on the
    dense view (the reference's K3/K4 in interpret mode where it routes
    them), f32. max_pool on integers: the tie split, exactly."""
    monkeypatch.setenv("RESUNETA_DENSEMM_INTERPRET", "1")
    rng = np.random.default_rng(sum(map(ord, name)))
    ours, ref, args = _glue(name, rng)
    dense = [jnp.asarray(a.reshape(a.shape[0], a.shape[1], -1)) if a.ndim == 4
             else jnp.asarray(a) for a in args]
    jy, vjp = jax.vjp(ref, *dense)
    cot = rng.standard_normal(jy.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = ours(*targs)
    torch.autograd.backward(y, torch.from_numpy(cot.reshape(y.shape)))
    exact = name == "max_pool"
    for got, want in [(y, jy)] + [(t.grad, jg) for t, jg in
                                  zip(targs, jgrads)]:
        got = _np(got).reshape(np.shape(want))
        if exact:
            np.testing.assert_array_equal(got, np.asarray(want))
        else:
            _close(got, want, False)


# ------------------------------------------------------------ PSPPooling

def test_dense_psp_matches_jax_module(monkeypatch):
    """PSPPooling(32, img_width=256) at 128 px in train mode, dense on both
    sides: all four levels, the port's K4 for k = 2, 4, 8 and one K3
    projection over ups (1, 2, 4, 8, 1); the reference's planner
    downgrades that to (1, 2, 4, 4, 1) at this width and materialises a x2
    upsample of the k = 8 level, the same values. Output, the input and
    parameter gradients and the updated BN statistics, f32, through BNs on
    batch statistics (each level's BN normalises 128^2/k^2 values)."""
    monkeypatch.setenv("RESUNETA_DENSEMM_INTERPRET", "1")
    S, C = 128, 32
    rng = np.random.default_rng(21)
    xn = (rng.standard_normal((1, S, S, C)) * 0.5).astype(np.float32)
    jpsp = jm.PSPPooling(C, 256, dtype=jnp.float32, act=True)
    variables = flax_variables(jpsp, [jnp.asarray(xn)], seed=22)
    xd = jnp.asarray(xn.reshape(1, S, S * C))

    def run(params, x):
        return jpsp.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x,
                          train=True, dense_width=S, mutable=["batch_stats"])

    (jy, jstats), vjp = jax.vjp(run, variables["params"], xd)
    cot = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, jstats)))

    psp = tmr.PSPPooling(C, 256, act=True)
    psp.load_state_dict(convert.from_flax(variables, psp), strict=True)
    psp.train()
    x = torch.from_numpy(xn).requires_grad_()
    k3, k4 = densemm.CALLS, poolconv.CALLS
    y = psp(x.permute(0, 3, 1, 2), dense=True)
    assert (densemm.CALLS - k3, poolconv.CALLS - k4) == (2, 3)
    y.permute(0, 2, 3, 1).backward(torch.from_numpy(cot.reshape(1, S, S, C)))
    _close(_np(y.permute(0, 2, 3, 1)).reshape(jy.shape), jy, False, 1e-4)
    _close(_np(x.grad).reshape(jgx.shape), jgx, False, 1e-4)
    # gradients within 1e-5 of the largest of them all: a conv bias before
    # a BN, and a level's BN offset (its output feeds a conv and a BN, whose
    # backward removes the per-channel mean), have a zero gradient, ~1e-4
    # of noise on both sides against gradients of ~1e2
    want = convert.from_flax({"params": jgp})
    got = {k: p.grad for k, p in psp.named_parameters()}
    assert sorted(got) == sorted(want)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), v.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    stats = convert.from_flax({"batch_stats": jstats["batch_stats"]})
    for k, v in psp.named_buffers():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
