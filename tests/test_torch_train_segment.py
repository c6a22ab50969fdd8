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
from util_torch import one_thread  # noqa: F401  (a fixture)

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


# ------------------------- K9: the C = 256 tiling of convseg_bwd.cu, emulated

SMS, SMEM_LIMIT = 132, 211 * 1024


def _geo(H, W, pix):
    """sm90::make_geo: BW = the power of two >= W up to pix, BH = pix /
    BW; (bw_log2, BH, tiles_h, tiles_w)."""
    bw_log2 = 0
    while (1 << bw_log2) < W and (2 << bw_log2) <= pix:
        bw_log2 += 1
    bh = pix >> bw_log2
    return bw_log2, bh, -(-H // bh), -(-W // (1 << bw_log2))


def _mtile_tap(C, mt):
    """convseg_bwd.cu mtile_tap at C >= 64: group mt // 3 holds the three
    taps of one stencil row at one block of 64 input channels."""
    grp, q = mt // 3, C // 64
    return (grp // q) * 3 + mt % 3, (grp % q) * 64


def _k9_emulation(x, g, a, b, mean, invstd, w, d, act):
    """convseg_bwd.cu at C = 256 in plain torch, in f32: tma_dgrad_kernel's
    work items (128-pixel tile, one 128-channel half of N) on persistent
    blocks that keep one half (the grid a multiple of 2, blocks 2r and
    2r + 1 sharing row r of the S1/S2/dc partials), each K step one gb box
    read with TMA's zero fill: with the halo (BW >= 64, BW + 2d <= 256 and
    two stages in shared memory) BW + 2d columns wide, the three taps of a
    stencil row at row offsets (2 - tx) d; else a box per tap. Then
    tma_wgrad_kernel: blocks (pixel chunk, group of three M tiles, N half),
    M tile -> (tap, c0) as mtile_tap, zb's box of a stencil row shared by
    its three taps at offsets (1 + tx) d (halo: 1 x 64 tiles) or a box per
    tap, one partial dW per chunk; the partials summed in chunk order.
    Also checks that every partial is written exactly once."""
    N, H, W, C = x.shape
    NC, NH, CB = 128, 2, 64
    wT = w.to(torch.bfloat16).float().permute(0, 1, 3, 2).reshape(9, C, C)
    gb = g.to(torch.bfloat16).float()
    P = 128 + 2 * d   # zero border: every box lies inside the padded tensor

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0, P, P, P, P))

    def box(tp, n, h, w_, rows, cols, c0, cn):
        return tp[n, h + P:h + P + rows, w_ + P:w_ + P + cols,
                  c0:c0 + cn].reshape(rows * cols, cn)

    # dgrad
    gp = padded(gb)
    PIX = 128
    bwl, bh, th, tw = _geo(H, W, PIX)
    bw = 1 << bwl
    tiles = N * th * tw
    a_bytes = -(-(bw + 2 * d) * bh * CB * 2 // 1024) * 1024
    smem2 = 2 * (a_bytes + 3 * 2 * CB * 128) + PIX * (NC + 8) * 4 + 1024
    halo = bw >= 64 and bw + 2 * d <= 256 and smem2 <= SMEM_LIMIT
    grid = min(SMS, tiles * NH)
    grid -= grid % NH
    zp = (x.double() * a.double() + b.double()).float()
    xhat = (x.float() - mean) * invstd
    dx = torch.full_like(x, float("nan"))
    zb = torch.zeros(N, H, W, C)
    part = torch.full((grid // NH, 3, C), float("nan"))
    for blk in range(grid):
        half = blk % NH
        cs = slice(half * NC, half * NC + NC)
        red = torch.zeros(3, NC)
        for t in range(blk, tiles * NH, grid):
            assert t % NH == half
            n, r = divmod(t // NH, th * tw)
            h0, w0 = (r // tw) * bh, (r % tw) * bw
            acc = torch.zeros(PIX, NC)
            for ty in range(3):
                for kc in range(C // CB):
                    if halo:
                        A = box(gp, n, h0 - (ty - 1) * d, w0 - d, bh,
                                bw + 2 * d, kc * CB, CB)
                        for q in range(PIX // 64):   # the two warpgroups
                            hrow = ((q * 64) >> bwl) * (bw + 2 * d) + \
                                ((q * 64) & (bw - 1))
                            for tx in range(3):
                                s = hrow + (2 - tx) * d
                                acc[64 * q:64 * q + 64] += A[s:s + 64] @ \
                                    wT[ty * 3 + tx, kc * CB:kc * CB + CB, cs]
                    else:
                        for tx in range(3):
                            A = box(gp, n, h0 - (ty - 1) * d,
                                    w0 - (tx - 1) * d, bh, bw, kc * CB, CB)
                            acc += A @ wT[ty * 3 + tx,
                                          kc * CB:kc * CB + CB, cs]
            p = torch.arange(PIX)
            hh, ww = h0 + (p >> bwl), w0 + (p & (bw - 1))
            keep = (hh < H) & (ww < W)
            hh, ww, dz = hh[keep], ww[keep], acc[keep]
            z = zp[n, hh, ww, cs]
            if act:
                dz = torch.where(z > 0, dz, torch.zeros(()))
                z = torch.relu(z)
            assert torch.isnan(dx[n, hh, ww, cs]).all()
            dx[n, hh, ww, cs] = (dz * a[cs]).to(x.dtype)
            zb[n, hh, ww, cs] = z.to(torch.bfloat16).float()
            red += torch.stack([dz.sum(0), (dz * xhat[n, hh, ww, cs]).sum(0),
                                g[n, hh, ww, cs].float().sum(0)])
        assert torch.isnan(part[blk // NH, :, cs]).all()
        part[blk // NH, :, cs] = red
    vec = part.sum(0)

    # wgrad
    zpad = padded(zb)
    bwl, bh, th, tw = _geo(H, W, 64)
    bw = 1 << bwl
    tiles = N * th * tw
    whalo = bw == 64 and 64 + 2 * d <= 256
    groups = 36 // 3
    target = SMS // (groups * NH)
    per = -(-tiles // target)
    chunks = -(-tiles // per)
    dwp = torch.full((chunks, 9, C, C), float("nan"))
    for ch in range(chunks):
        for y in range(groups * NH):
            group, o_base = y % groups, (y // groups) * NC
            for wg in range(3):
                tap, c0 = _mtile_tap(C, group * 3 + wg)
                ty, tx = tap // 3 - 1, tap % 3 - 1
                acc = torch.zeros(64, NC)
                for t in range(ch * per, min(ch * per + per, tiles)):
                    n, r = divmod(t, th * tw)
                    h0, w0 = (r // tw) * bh, (r % tw) * bw
                    B = box(gp, n, h0, w0, bh, bw, o_base, NC)
                    if whalo:
                        Z = box(zpad, n, h0 + ty * d, w0 - d, 1, 64 + 2 * d,
                                c0, 64)
                        A = Z[(tx + 1) * d:(tx + 1) * d + 64]
                    else:
                        A = box(zpad, n, h0 + ty * d, w0 + tx * d, bh, bw,
                                c0, 64)
                    acc += A.T @ B
                blk = dwp[ch, tap, c0:c0 + 64, o_base:o_base + NC]
                assert torch.isnan(blk).all()
                blk.copy_(acc)
    dw = dwp[0].clone()
    for ch in range(1, chunks):
        dw += dwp[ch]
    return dx, dw.reshape(3, 3, C, C), vec


@pytest.mark.parametrize("N,H,W,d", [
    (1, 16, 32, 1),     # 4 x 32 dgrad tiles, 2 x 32 wgrad tiles: no halo
    (1, 16, 32, 15),
    (1, 64, 64, 1),     # 2 x 64 tiles: dgrad's and wgrad's halo boxes
    (1, 64, 64, 15),    # dgrad: the halo's two stages overflow, a box a tap
    (2, 3, 80, 3),      # 1 x 128 tiles overhanging W by 48, two images
    (1, 2, 128, 70),    # BW + 2d > 256: a box a tap at W >= 64
])
@pytest.mark.usefixtures("one_thread")
def test_k9_tiling_emulation_matches_plain(N, H, W, d):
    """K9's work items, halo tap offsets, M tile -> (tap, c0) map and
    chunked dW partials, emulated in torch, against segment_bwd_reference
    in f32. Only the order of the f32 sums differs (the products of bf16
    values are exact in f32): dx, dW and [S1, S2, dc] within 1e-4 of
    their largest magnitude, the card tests' limits (_k2_close)."""
    C = 256
    x, g, gamma, beta, mean, var, w, _ = (
        torch.from_numpy(v) for v in _inputs(N, H, W, C, 30 * W + d))
    a, b, invstd = convseg.segment_affine(gamma, beta, mean, var)
    for act in (True, False):
        got = _k9_emulation(x, g, a, b, mean, invstd, w, d, act)
        want = convseg.segment_bwd_reference(x, g, a, b, mean, invstd, w,
                                             dilation=d, act=act)
        for gt, wt in zip(got, want):
            torch.testing.assert_close(gt, wt, rtol=0,
                                       atol=1e-4 * wt.abs().max().item())


def test_k2_design_is_the_tma_kernels_at_every_c():
    """K2 and K9 run TMA-fed wgmma kernels at every channel count the
    backward takes (chip_smoke's k2 rows report it); others raise."""
    assert [convseg.k2_design(C) for C in convseg.BWD_CHANNELS] == \
        ["tma_wgmma"] * 4
    with pytest.raises(ValueError):
        convseg.k2_design(512)
