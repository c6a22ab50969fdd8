"""The train segment of the PyTorch port (resuneta_torch/ops/convseg.py):
K2's plain version against the Pallas backward kernel it replaces
(resuneta_tpu/ops/pallas/convseg.py _segment_bwd_pallas + _fold_cotangents)
run in interpret mode on the CPU, and FusedSegment's gradients against
autograd of the plain composition and against jax.grad of the reference's
fused_segment. Inputs are drawn with numpy and handed to both frameworks.

Both sides round z = x*a + b once to f32, then z, g and the taps to bf16,
and sum products in f32; only the order of the sums differs (and, for an
element whose z_pre lies within an f32 ulp of 0, the ReLU mask)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch.ops import convseg
from resuneta_tpu.ops.pallas import convseg as jconvseg

NAMES = ["dx", "dgamma", "dbeta", "dmean", "dvar", "dw", "dbias"]


def _inputs(N, H, W, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    g = rng.standard_normal((N, H, W, C)).astype(np.float32)
    gamma = (rng.standard_normal(C) * 0.4 + 1).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.2).astype(np.float32)
    mean = (rng.standard_normal(C) * 0.1).astype(np.float32)
    var = (np.abs(rng.standard_normal(C)) + 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) / (3 * C ** 0.5)).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, g, gamma, beta, mean, var, w, bias


def _jax_cotangents(x, g, gamma, beta, mean, var, w, d):
    xj, gj, gaj, bej, mj, vj, wj = map(jnp.asarray,
                                       (x, g, gamma, beta, mean, var, w))
    a, b, invstd = jconvseg._affine(gaj, bej, mj, vj, 1e-3)
    dx, dwblk, vecs = jconvseg._segment_bwd_pallas(
        xj, gj, a, b, mj, invstd, jconvseg._block_w(wj), dilation=d,
        act=True, interpret=True)
    return [np.asarray(t) for t in jconvseg._fold_cotangents(
        dx, dwblk, vecs, xj, gaj, invstd, wj)]


CASES = [(2, 32, 32, C, d) for C, ds in ((32, (1, 3, 15, 31)),
                                         (64, (1, 3, 15, 31)),
                                         (128, (1, 3, 15))) for d in ds] + \
    [(1, 64, 64, 32, 31)]


@pytest.mark.parametrize("N,H,W,C,d", CASES)
def test_k2_plain_matches_pallas_interpret(N, H, W, C, d):
    """All seven cotangents. Tolerance: 1e-4 of each cotangent's largest
    magnitude plus 1e-5 relative. f32 sums of up to 2048 bf16 products in
    another order give ~1e-6 of it; the rest is room for one z element that
    XLA rounds to the other bf16 neighbour at an exact f32 tie (seen once,
    at C=32 d=31: z = 0x3eb58000, one row of the centre tap off by
    |g|*2^-9 = 5.3e-3 against a largest |dW| of 160, 3.3e-5 of it)."""
    x, g, gamma, beta, mean, var, w, bias = _inputs(N, H, W, C, 100 * C + d)
    want = _jax_cotangents(x, g, gamma, beta, mean, var, w, d)
    t = [torch.from_numpy(v) for v in (x, g, gamma, beta, mean, var, w)]
    a, b, invstd = convseg.segment_affine(t[2], t[3], t[4], t[5])
    calls, launches = convseg.BWD_CALLS, convseg.BWD_LAUNCHES
    dx, dw, vec = convseg.segment_bwd(t[0], t[1], a, b, t[4], invstd, t[6],
                                      dilation=d)
    got = convseg.fold_cotangents(dx, dw, vec, t[2], invstd)
    assert convseg.BWD_CALLS == calls + 1 and convseg.BWD_LAUNCHES == launches
    for name, gt, wt in zip(NAMES, got, want):
        gt = gt.numpy()
        assert gt.shape == wt.shape and gt.dtype == np.float32, name
        scale = float(np.abs(wt).max())
        np.testing.assert_allclose(gt, wt, rtol=1e-5, atol=1e-4 * scale,
                                   err_msg=name)


def test_affine_follows_the_segment_order():
    """a = γ·invstd, b = β − mean·a in f32, as convseg._affine. Within two
    f32 ulps of the vector's largest element: XLA's and PyTorch's rsqrt are
    not correctly rounded and differ in the last bit now and then, and b's
    cancellation carries that ulp of a into small elements of b."""
    _, _, gamma, beta, mean, var, _, _ = _inputs(1, 1, 1, 64, 3)
    want = jconvseg._affine(*map(jnp.asarray, (gamma, beta, mean, var)), 1e-3)
    got = convseg.segment_affine(*map(torch.from_numpy,
                                      (gamma, beta, mean, var)))
    for gt, wt in zip(got, want):
        wt = np.asarray(wt)
        np.testing.assert_allclose(gt.numpy(), wt, rtol=0,
                                   atol=2.4e-7 * np.abs(wt).max())


def _plain_composition(x, gamma, beta, mean, var, w, bias, d):
    """The segment as separate differentiable ops with the kernels'
    roundings: z in f32 (an exact f64 product), bf16 z and taps, f32 conv."""
    invstd = torch.rsqrt(var + 1e-3)
    a = gamma * invstd
    b = beta - mean * a
    z = torch.relu((x.double() * a.double() + b.double()).float())
    zb = z.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = torch.nn.functional.conv2d(zb, wb, padding=d, dilation=d)
    return y.permute(0, 2, 3, 1) + bias


@pytest.mark.parametrize("d", [1, 15])
def test_fused_segment_grads(d):
    """FusedSegment's seven gradients against autograd of the plain
    composition and against jax.grad of the reference's fused_segment (K1
    and K2 in interpret mode). Both at the ceiling of
    tests/test_pallas_convseg.py:186 (rtol 0.06, atol 0.06 of the largest
    magnitude); observed far below it."""
    N, H, W, C = 2, 32, 32, 32
    x, cot, gamma, beta, mean, var, w, bias = _inputs(N, H, W, C, 7 + d)
    args = [torch.from_numpy(v).requires_grad_() for v in
            (x, gamma, beta, mean, var, w, bias)]
    y = convseg.fused_segment(*args, dilation=d)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), args)

    args2 = [a.detach().clone().requires_grad_() for a in args]
    y2 = _plain_composition(*args2, d)
    plain = torch.autograd.grad((y2 * torch.from_numpy(cot)).sum(), args2)

    def loss(*p):
        yj = jconvseg.fused_segment(d, 1e-3, True, True, *p)
        return jnp.sum(yj.astype(jnp.float32) * jnp.asarray(cot))

    ref = jax.grad(loss, argnums=tuple(range(7)))(
        *map(jnp.asarray, (x, gamma, beta, mean, var, w, bias)))
    for name, gt, pt, rt in zip(NAMES, got, plain, ref):
        gt, pt, rt = gt.numpy(), pt.numpy(), np.asarray(rt)
        for other in (pt, rt):
            scale = max(float(np.abs(other).max()), 1e-3)
            np.testing.assert_allclose(gt, other, rtol=0.06,
                                       atol=0.06 * scale, err_msg=name)


# ------------------------------------------- the opt-in modes' segments

def _vjp(fn, primals, cot):
    """(y, the cotangents of every primal) of a JAX function, as numpy."""
    y, vjp = jax.vjp(fn, *map(jnp.asarray, primals))
    return [np.asarray(y)] + [np.asarray(t) for t in vjp(jnp.asarray(cot))]


def _torch_grads(fn, primals, cot):
    """(y, the gradient of every primal) of the port's function."""
    args = [torch.from_numpy(v).requires_grad_() for v in primals]
    y = fn(*args)
    grads = torch.autograd.grad(y, args, torch.from_numpy(cot))
    return [y.detach().numpy()] + [g.numpy() for g in grads]


def _assert_close(got, want, names, rtol=1e-5, atol_of_max=1e-4):
    """Each output within `atol_of_max` of its largest magnitude plus
    `rtol` relative (the K2 interpret test's limits)."""
    for name, gt, wt in zip(names, got, want):
        assert gt.shape == wt.shape, name
        scale = max(float(np.abs(wt).max()), 1e-6)
        np.testing.assert_allclose(gt, wt, rtol=rtol,
                                   atol=atol_of_max * scale, err_msg=name)


@pytest.mark.parametrize("N,H,W,d", [(1, 16, 16, 3), (1, 32, 32, 1)])
def test_wide_fused_segment_matches_pallas_interpret(N, H, W, d):
    """FusedSegment at C = 256 (K1 + K9's plain versions) against jax.vjp
    of the reference's fused_segment with its wide tier's kernels in
    interpret mode, at the geometries that tier plans
    (tests/test_pallas_convseg.py:76-85). Both sides round z and the taps
    to bf16 and sum in f32: y and the seven gradients within 1e-4 of their
    largest magnitude plus 1e-5 relative (the K2 interpret test's limits;
    the order of the sums is all that differs)."""
    C = 256
    x, cot, gamma, beta, mean, var, w, bias = _inputs(N, H, W, C, 50 + d)
    primals = (x, gamma, beta, mean, var, w, bias)
    want = _vjp(lambda *p: jconvseg.fused_segment(d, 1e-3, True, True, *p),
                primals, cot)
    calls = convseg.BWD_CALLS
    got = _torch_grads(lambda *p: convseg.fused_segment(*p, dilation=d),
                       primals, cot)
    assert convseg.BWD_CALLS == calls + 1
    _assert_close(got, want, ["y"] + NAMES)


def _identity(C):
    """The dense tail's identity affine, as the reference builds it
    (resuneta.py:129-131): γ = 1, β = 0, mean = 0, var = 1 − 1e-3 in f32,
    so a = rsqrt(var + 1e-3) = 1 and b = 0."""
    ones = np.ones(C, np.float32)
    zeros = np.zeros(C, np.float32)
    return ones, zeros, zeros, ones - np.float32(1e-3)


@pytest.mark.parametrize("d", [1, 3])
def test_segment_without_act_matches_pallas_interpret(d):
    """act = False on the identity affine (the tail's seg1, Conv_6 and
    Conv_8 in mode "1"): the port's FusedSegment (K1 and K2 plain, no ReLU
    mask, zb = bf16(z_pre)) against jax.vjp of the reference's
    fused_segment_dense(W, d, 1e-3, False, True, ...) on the dense view;
    y and the seven gradients at the limits above."""
    N, H, W, C = 2, 32, 32, 32
    x, cot, _, _, _, _, w, bias = _inputs(N, H, W, C, 70 + d)
    gamma, beta, mean, var = _identity(C)
    primals = (x, gamma, beta, mean, var, w, bias)

    def ref(x, *p):
        y = jconvseg.fused_segment_dense(W, d, 1e-3, False, True,
                                         x.reshape(N, H, W * C), *p)
        return y.reshape(N, H, W, C)

    want = _vjp(ref, primals, cot)
    got = _torch_grads(lambda *p: convseg.fused_segment(
        *p, dilation=d, act=False), primals, cot)
    np.testing.assert_array_equal(
        torch.rsqrt(torch.from_numpy(var) + 1e-3).numpy(), 1.0)
    _assert_close(got, want, ["y"] + NAMES)


@pytest.mark.parametrize("C,d", [(32, 1), (32, 3), (64, 1), (64, 3)])
def test_bwdonly_segment_matches_the_reference(C, d):
    """K10, segment mode "2": FusedSegmentBwdOnly (a plain f32 forward, K2's
    plain version backward) against jax.vjp of the reference's
    fused_segment_bwdonly(d, 1e-3, True, True, ...) (its forward in XLA,
    its K2 in interpret mode). y within 1e-5 of its largest magnitude (f32
    convolutions; z = x·a + b rounded once there, twice here), the seven
    gradients at the limits above."""
    N, H, W = 2, 16, 16
    x, cot, gamma, beta, mean, var, w, bias = _inputs(N, H, W, C, 90 + d)
    primals = (x, gamma, beta, mean, var, w, bias)
    want = _vjp(lambda *p: jconvseg.fused_segment_bwdonly(
        d, 1e-3, True, True, *p), primals, cot)
    calls, bwd_calls = convseg.CALLS, convseg.BWD_CALLS
    got = _torch_grads(lambda *p: convseg.fused_segment(
        *p, dilation=d, bwd_only=True), primals, cot)
    # a plain forward (no K1 call), K2's backward
    assert (convseg.CALLS, convseg.BWD_CALLS) == (calls, bwd_calls + 1)
    _assert_close(got[:1], want[:1], ["y"], rtol=0, atol_of_max=1e-5)
    _assert_close(got[1:], want[1:], NAMES)
