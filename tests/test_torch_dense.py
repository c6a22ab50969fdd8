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
from util_torch import one_thread  # noqa: F401  (a fixture)


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


# ------------------------------------------------- K3's Hopper tiling
#
# densemm.cu's bf16 kernels emulated in plain torch: the tile geometry
# (sm90::make_geo), each part's TMA box (origin, extent, zero fill where
# it leaves the tensor or its channels), the K padding of narrow parts
# (16-channel wgmma steps over zero-filled rows, W's padded rows zero), the
# in-place forming of an upsampled or ReLU'd part (x k replication, the
# ReLU), the strided part's map of the output geometry, the row sums gg_k
# (f32 sum of k rows, one bf16 rounding) read through dgrad's 5-D map one
# column replica at a time, dgrad's column groups and the strided dx's
# zeros, and wgrad's units (two 64-channel slices of one k's parts), their
# pixel chunks (a k-th of them for an upsampled part's, zero partials
# past them), the per-block partial dW and dbias and their fixed-order
# sum. Held to the plain versions (which the card tests hold the kernels
# to) and at one shape to the Pallas kernel in interpret mode. Tolerance:
# bf16 results one bf16 ulp + 1e-3 of the largest magnitude; f32 ones (dW,
# dbias) 1e-5 of the largest magnitude: the emulation sums f32 products in
# tile order, the plain version in one matmul, so only the order of the
# f32 sums differs.

def _geo(N, H, W, pix):
    bwl = 0
    while (1 << bwl) < W and (2 << bwl) <= pix:
        bwl += 1
    bw, bh = 1 << bwl, pix >> bwl
    tiles = torch.tensor([(n, h0, w0) for n in range(N)
                          for h0 in range(0, H, bh) for w0 in range(0, W, bw)])
    return bwl, bw, bh, tiles


def _boxes(t, tiles, rows, cols, c0, s=1, k=1, kh=None):
    """TMA boxes of 64 channels x cols x rows from (c0, w0 / k, h0 / kh,
    n) of every tile (kh = k unless given), through a map of t with
    element strides s (dims H / s, W / s), zero outside t: (tiles, rows *
    cols, 64) f32."""
    kh = k if kh is None else kh
    v = t[:, ::s, ::s].float() if s > 1 else t.float()
    _, hv, wv, C = v.shape
    n, h0, w0 = tiles.unbind(1)
    hh = (h0 // kh)[:, None] + torch.arange(rows)
    ww = (w0 // k)[:, None] + torch.arange(cols)
    inside = (hh < hv)[:, :, None] & (ww < wv)[:, None, :]
    vals = v[n[:, None, None], hh.clamp(max=hv - 1)[:, :, None],
             ww.clamp(max=wv - 1)[:, None, :]] * inside[..., None]
    box = torch.zeros(len(tiles), rows, cols, 64)
    cc = min(64, C - c0)
    box[..., :cc] = vals[..., c0:c0 + cc]
    return box.reshape(len(tiles), rows * cols, 64)


def _pad(n):
    p = 8
    while p < n:
        p *= 2
    return p


def _ksteps(c):
    """wgmma K steps of 16 over a slice of c <= 64 channels."""
    return -(-min(64, c) // 16) * 16


def _emu_fwd(xs, w, bias, acts, ups, strides, N, H, W):
    cout, koff = w.shape[1], 0
    NP = _pad(cout)
    bwl, bw, bh, tiles = _geo(N, H, W, 128)
    wT = torch.zeros(NP, w.shape[0])
    wT[:cout] = w.t().to(torch.bfloat16).float()
    acc = torch.zeros(len(tiles), 128, NP)
    r = torch.arange(128)
    for x, a, k, s in zip(xs, acts, ups, strides):
        cin = x.shape[3]
        for c0 in range(0, cin, 64):
            if k > 1 or a:   # the raw box, replicated x k (and the ReLU)
                raw = _boxes(x, tiles, max(bh // k, 1), bw // k, c0, s, k)
                h0, w0 = tiles[:, 1:2], tiles[:, 2:3]
                rr = (h0 + (r >> bwl)) // k - h0 // k
                rc = (w0 + (r & (bw - 1))) // k - w0 // k
                A = raw[torch.arange(len(tiles))[:, None], rr * (bw // k) + rc]
                A = torch.relu(A) if a else A
            else:
                A = _boxes(x, tiles, bh, bw, c0, s)
            B = torch.zeros(64, NP)           # W^T's region, K-major
            cc = min(64, cin - c0)
            B[:cc] = wT[:, koff + c0:koff + c0 + cc].t()
            ks = _ksteps(cin - c0)
            acc += A[..., :ks] @ B[:ks]
        koff += cin
    y = torch.full((N, H, W, cout), float("nan"))
    n, h, ww = tiles[:, 0:1], tiles[:, 1:2] + (r >> bwl), \
        tiles[:, 2:3] + (r & (bw - 1))
    keep = (h < H) & (ww < W)
    y[n.expand_as(h)[keep], h[keep], ww[keep]] = \
        acc[keep][:, :cout] + bias.float()
    return y.to(xs[0].dtype)


def _rowsum_ws(g, k):
    """k3_rowsum_kernel's gg_k: bf16 of the f32 sum of k rows of g, top
    to bottom: (N, H / k, W, cout)."""
    gf = g.float()
    acc = gf[:, 0::k]
    for a in range(1, k):
        acc = acc + gf[:, a::k]
    return acc.to(torch.bfloat16)


def _dgrad_groups(cins, ups):
    """dgrad's column groups (densemm.cu k3::backward): the parts at the
    output's resolution or strided while their channels fit 256 columns,
    then each upsampled part alone. -> [(k, [parts])]"""
    groups = []
    for k in (1, 2, 4, 8):
        for p, (c, kk) in enumerate(zip(cins, ups)):
            if kk != k:
                continue
            if groups and k == 1 and \
                    sum(cins[q] for q in groups[-1][1]) + c <= 256:
                groups[-1][1].append(p)
            else:
                groups.append((k, [p]))
    return groups


def _emu_dgrad(xs, g, w, acts, ups, strides, N, H, W):
    cins = [x.shape[3] for x in xs]
    cout = w.shape[1]
    koffs = np.cumsum([0] + cins)
    groups = _dgrad_groups(cins, ups)
    NP = _pad(max(sum(cins[p] for p in ps) for _, ps in groups))
    wb = w.to(torch.bfloat16).float()
    dxs = [torch.full(x.shape, float("nan")) for x in xs]
    for k, ps in groups:
        hq, wq = (H // k, W // k) if k > 1 else (H, W)
        bwl, bw, bh, tiles = _geo(N, hq, wq, 128)
        r = torch.arange(128)
        n, h = tiles[:, 0:1], tiles[:, 1:2] + (r >> bwl)
        wc = tiles[:, 2:3] + (r & (bw - 1))
        inside = (h < hq) & (wc < wq)
        ggk = _rowsum_ws(g, k)
        cols = np.cumsum([0] + [cins[p] for p in ps])
        acc = torch.zeros(len(tiles), 128, NP)
        for b in range(k):
            for o0 in range(0, cout, 64):
                if k > 1:   # replica b of gg_k: the 5-D map's box
                    A = _boxes(ggk[:, :, b::k], tiles, bh, bw, o0)
                else:
                    A = _boxes(g, tiles, bh, bw, o0)
                B = torch.zeros(64, NP)   # the members' W rows, K-major
                oc = min(64, cout - o0)
                for p, c0 in zip(ps, cols):
                    B[:oc, c0:c0 + cins[p]] = \
                        wb[koffs[p]:koffs[p] + cins[p], o0:o0 + oc].t()
                ks = _ksteps(cout - o0)
                acc += A[..., :ks] @ B[:ks]
        nn_, hh, wwc = n.expand_as(h)[inside], h[inside], wc[inside]
        for p, c0 in zip(ps, cols):
            s, x, dx = strides[p], xs[p], dxs[p]
            v = acc[inside][:, c0:c0 + cins[p]]
            if acts[p]:
                v = torch.where(x[nn_, hh * s, wwc * s].float() > 0, v,
                                torch.zeros(()))
            for i in range(s):
                for j in range(s):
                    dx[nn_, hh * s + i, wwc * s + j] = \
                        v if i == j == 0 else 0.0
    return [dx.to(x.dtype) for dx, x in zip(dxs, xs)]


WPIX = 64   # wgrad's pixels a stage


def _units(cins, ups):
    """wgrad's units (densemm.cu k3::make_units): for k = 1, 2, 4, 8 the
    64-channel slices of that k's parts, two a unit; the first unit (k =
    1) also sums dbias. -> [(k, dbias, [(part, slice)])]"""
    units = []
    for k in (1, 2, 4, 8):
        sls = [(p, sl) for p, (c, kk) in enumerate(zip(cins, ups)) if kk == k
               for sl in range(-(-c // 64))]
        units += [(k, k == 1 and i == 0, sls[i:i + 2])
                  for i in range(0, len(sls), 2)]
    return units


def _emu_wgrad(xs, g, acts, ups, strides, N, H, W, chunks):
    cins = [x.shape[3] for x in xs]
    cout, ktot = g.shape[3], sum(cins)
    koffs = np.cumsum([0] + cins)
    NP = max(64, _pad(cout))
    part = torch.full((chunks, ktot + 1, cout), float("nan"))
    for k, dbias, mt in _units(cins, ups):
        # q: the WPIX-pixel tiles of (N, H / k, W); B from g or gg_k
        bwl, bw, bh, tiles = _geo(N, H // k, W, WPIX)
        src = g if k == 1 else _rowsum_ws(g, k)
        blocks = -(-chunks // k)   # the unit's blocks, a k-th of the pixels
        per = -(-len(tiles) // blocks)
        q = torch.arange(WPIX)
        for chunk in range(chunks):   # partials past the unit's blocks: 0
            ts = tiles[chunk * per:(chunk + 1) * per] if chunk < blocks \
                else tiles[:0]
            B = torch.cat([_boxes(src, ts, bh, bw, nb * 64)
                           for nb in range(NP // 64)], 2) if len(ts) else \
                torch.zeros(0, WPIX, NP)
            for p, sl in mt:
                if not len(ts):
                    A = torch.zeros(0, WPIX, 64)
                elif k > 1:   # the raw box, replicated k times along rows
                    raw = _boxes(xs[p], ts, bh, bw // k, sl * 64, 1, k, 1)
                    A = raw[:, (q >> bwl) * (bw // k) + (q & (bw - 1)) // k]
                else:
                    A = _boxes(xs[p], ts, bh, bw, sl * 64, strides[p])
                A = torch.relu(A) if acts[p] else A
                d = (A.transpose(1, 2) @ B).sum(0)   # (64, NP)
                cc = min(64, cins[p] - sl * 64)
                row = koffs[p] + sl * 64
                part[chunk, row:row + cc] = d[:cc, :cout]
            if dbias:   # RG row groups of the staged boxes, in order
                rg = 2048 // NP
                red = B.reshape(-1, WPIX // rg, rg, NP).sum((0, 1))
                part[chunk, ktot] = red.sum(0)[:cout]
    assert not part.isnan().any(), "a partial row was not written"
    # densemm_reduce_kernel: 32 row groups a column, then their sum
    rows = -(-chunks // 32) * 32
    padded = torch.zeros(rows, ktot + 1, cout)
    padded[:chunks] = part
    dwb = padded.reshape(rows // 32, 32, ktot + 1, cout).sum(0).sum(0)
    return dwb[:-1], dwb[-1]


# the 12 calls of the 256 px step (chip_smoke.K3_CALLS) at N = 1-2 and
# output 32-64 px: (name, parts (cin, act, ups, stride), cout, N, H, W),
# and two ragged shapes (W not a power of two, a tile overhanging)
EMU_CASES = [
    ("Conv_1 s2", ((32, False, 1, 2),), 64, 2, 32, 32),
    ("Conv_2 s2", ((64, False, 1, 2),), 128, 1, 32, 32),
    ("Conv_3 s2", ((128, False, 1, 2),), 256, 1, 32, 32),
    ("UpSampleConv_2", ((256, False, 1, 1),), 64, 1, 32, 32),
    ("Combine_2", ((64, True, 2, 1), (128, False, 1, 1)), 128, 1, 32, 32),
    ("UpSampleConv_3", ((128, False, 1, 1),), 32, 2, 32, 32),
    ("Combine_3", ((32, True, 2, 1), (64, False, 1, 1)), 64, 2, 32, 32),
    ("UpSampleConv_4", ((64, False, 1, 1),), 16, 2, 64, 64),
    ("Combine_4", ((16, True, 2, 1), (32, False, 1, 1)), 32, 2, 64, 64),
    ("Combine_5", ((32, True, 1, 1), (32, False, 1, 1)), 32, 1, 64, 64),
    ("PSP level 1", ((32, False, 1, 1),), 8, 1, 64, 64),
    ("PSP projection", ((8, False, 1, 1), (8, False, 2, 1),
                        (8, False, 4, 1), (8, False, 8, 1),
                        (32, False, 1, 1)), 32, 1, 64, 64),
    ("ragged", ((16, True, 2, 1), (24, False, 1, 1)), 40, 1, 20, 40),
    ("ragged s2", ((8, True, 1, 2),), 24, 2, 12, 20),
]


def _emu_inputs(parts, cout, N, H, W, seed):
    rng = np.random.default_rng(seed)
    xs = []
    for c, _, k, s in parts:
        h, w = (H * s, W * s) if s > 1 else (H // k, W // k)
        xs.append(torch.from_numpy(rng.standard_normal(
            (N, h, w, c)).astype(np.float32)).to(torch.bfloat16))
    cin = sum(p[0] for p in parts)
    w = torch.from_numpy((rng.standard_normal((cin, cout)) / cin ** 0.5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((N, H, W, cout)).astype(
        np.float32)).to(torch.bfloat16)
    spec = {"acts": [p[1] for p in parts], "ups": [p[2] for p in parts],
            "strides": [p[3] for p in parts]}
    return xs, w, b, g, spec


@pytest.mark.parametrize("case", range(len(EMU_CASES)),
                         ids=[c[0].replace(" ", "_") for c in EMU_CASES])
@pytest.mark.usefixtures("one_thread")
def test_k3_tiling_emulation_matches_plain(case):
    name, parts, cout, N, H, W = EMU_CASES[case]
    xs, w, b, g, spec = _emu_inputs(parts, cout, N, H, W, case)
    assert densemm.refusal([p[0] for p in parts], cout, spec["ups"]) is None
    scale = 2 ** -7

    def bf16_close(got, want):
        torch.testing.assert_close(
            got.float(), want.float(), rtol=scale,
            atol=1e-3 * want.float().abs().max().item())

    def f32_close(got, want):
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-5 * want.abs().max().item())

    y = _emu_fwd(xs, w, b, spec["acts"], spec["ups"], spec["strides"],
                 N, H, W)
    bf16_close(y, densemm.dense_mm_reference(xs, w, b, **spec))
    wdxs, wdw, wdb = densemm.dense_mm_bwd_reference(xs, g, w, **spec)
    dxs = _emu_dgrad(xs, g, w, spec["acts"], spec["ups"], spec["strides"],
                     N, H, W)
    for dx, wdx in zip(dxs, wdxs):
        bf16_close(dx, wdx)
    chunks = densemm.bf16_wgrad_chunks([p[0] for p in parts], spec["ups"],
                                       N * H * W)
    for ch in sorted({1, 3, chunks}):
        dw, db = _emu_wgrad(xs, g, spec["acts"], spec["ups"],
                            spec["strides"], N, H, W, ch)
        f32_close(dw, wdw)
        f32_close(db, wdb)


def test_k3_tiling_emulation_matches_pallas_interpret():
    """One shape (K3_CASES[3]: a ReLU'd x2 part and a plain skip, bf16)
    of the emulated tiling against the Pallas kernel in interpret mode,
    forward and jax.vjp, at the plain version's tolerances above."""
    N, H, W, cins, cout, acts, ups = K3_CASES[3]
    xs, w, b, g = _k3_inputs(K3_CASES[3], 3, "bfloat16")
    spec = (W, cins, cout, acts, ups)
    offs = np.cumsum((0,) + cins)
    jxs = tuple(jnp.asarray(x.reshape(N, x.shape[1], -1), jnp.bfloat16)
                for x in xs)
    jws = tuple(jnp.asarray(w[offs[i]:offs[i + 1]]) for i in range(len(cins)))
    jy, vjp = jax.vjp(lambda xs_, ws_, b_: jdensemm.dense_mm(
        spec, True, xs_, ws_, b_), jxs, jws, jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g.reshape(N, H, -1), jnp.bfloat16))
    txs = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    tg = torch.from_numpy(g).to(torch.bfloat16)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    st = (1,) * len(cins)
    y = _emu_fwd(txs, tw, tb, acts, ups, st, N, H, W)
    dxs = _emu_dgrad(txs, tg, tw, acts, ups, st, N, H, W)
    dw, db = _emu_wgrad(txs, tg, acts, ups, st, N, H, W, 3)
    _close(_np(y).reshape(N, H, -1), jy, True)
    for dx, jd in zip(dxs, jdx):
        _close(_np(dx).reshape(jd.shape), jd, True)
    _close(_np(dw), np.concatenate([np.asarray(d) for d in jdw]), False, 1e-4)
    _close(_np(db), jdb, False, 1e-4)


def test_k3_refusal_states_the_bf16_limits():
    """The bf16 kernels' limits (densemm.cu k3::refusal): every path call
    passes; wider than one wgmma, ups not a power of two, no part at the
    output's resolution, W over the shared memory budget do not."""
    for _, parts, cout in [(c[0], c[1], c[2]) for c in EMU_CASES]:
        assert densemm.refusal([p[0] for p in parts], cout,
                               [p[2] for p in parts]) is None
    assert densemm.refusal([32], 264, [1])
    assert densemm.refusal([264], 32, [1])
    assert densemm.refusal([32, 32], 32, [3, 1])
    assert densemm.refusal([32, 32], 32, [16, 1])
    assert densemm.refusal([32], 32, [2])
    assert densemm.refusal([256] * 5, 256, [1] * 5)
    assert densemm.k3_design(torch.bfloat16) == "tma_wgmma"
    assert densemm.k3_design(torch.float32) == "pr3"
