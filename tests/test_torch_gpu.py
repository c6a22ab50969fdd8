"""Tests of the PyTorch port that need a CUDA card: the kernels (K1 to K9)
against their plain versions, the mode-"2" segment (K10), the wrappers
raising on what their kernels do not take and off the current device, the
data-parallel step as two ranks sharing the card, and height-sharded as a
1 x 2 space mesh, with the halo alone (`-k "two_ranks or space or
halo"`), the device-time reader (`-k xprof`), the 64 px model and train
step on the card against the CPU plain path (in the default routing and
in each opt-in mode), one 512 px train step's kernel launches, and the
Amazon step (64 px, card against the CPU) with K3 and K4 in f32 at its
128 px shapes (`-k amazon`), the V1 and legacy models' segments on the
card and the rematerialised step's launches (`-k "v1 or legacy or
remat"`). They skip without a card. This file imports no JAX, so it runs
where only PyTorch is installed, without the JAX-importing
tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from resuneta_torch.models import ResUnetA
from resuneta_torch.ops import boundary, convseg, densemm, distance, poolconv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _inputs(N, H, W, C, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    a = (rng.standard_normal(C) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.2).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) / (3 * C ** 0.5)).astype(
        np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return [torch.from_numpy(t).to(device) for t in (x, a, b, w, bias)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,H,W,C,d", [(2, 32, 32, 32, 31),
                                       (2, 16, 16, 128, 15),
                                       (3, 24, 40, 64, 3),
                                       (1, 8, 8, 256, 1)])
def test_kernel_matches_plain(cuda, N, H, W, C, d, dtype):
    """The plain version repeats the kernel's roundings; only the order of
    the f32 sums differs. f32 out: 1e-4 abs on values of magnitude ~1-4.
    bf16 out: a one-ulp flip of the final rounding, at most 2^-7 relative."""
    x, a, b, w, bias = _inputs(N, H, W, C, C + d, cuda)
    x = x.to(dtype)
    launches = convseg.LAUNCHES
    got = convseg.bn_act_conv(x, a, b, w, bias, dilation=d)
    torch.cuda.synchronize()
    assert convseg.LAUNCHES == launches + 1
    assert got.dtype == dtype and got.shape == (N, H, W, C)
    want = convseg.bn_act_conv_reference(x, a, b, w, bias, dilation=d)
    tol = (2 ** -7, 2 ** -7) if dtype == torch.bfloat16 else (0, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.gpu
def test_wrapper_raises_on_cuda_instead_of_falling_back(cuda):
    x, a, b, w, bias = _inputs(1, 8, 8, 32, 0, cuda)
    with pytest.raises(ValueError):
        convseg.bn_act_conv(x, a.cpu(), b, w, bias, dilation=1)
    with pytest.raises(ValueError):
        convseg.bn_act_conv(x[..., :16].contiguous(), a[:16], b[:16],
                            w[:, :, :16, :16].contiguous(), bias[:16],
                            dilation=1)


def _k1_close(got, want, dtype):
    """test_kernel_matches_plain's limits: f32 out 1e-4 abs (values of
    magnitude ~1-4, only the order of the f32 sums differs); bf16 out a
    one-ulp flip of the final rounding, 2^-7 relative and absolute."""
    tol = (2 ** -7, 2 ** -7) if dtype == torch.bfloat16 else (0, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


def _k1_call(x, a, b, w, bias, d, act=True):
    """One K1 call on the card: one launch, y of x's dtype and shape."""
    launches = convseg.LAUNCHES
    got = convseg.bn_act_conv(x, a, b, w, bias, dilation=d, act=act)
    torch.cuda.synchronize()
    assert convseg.LAUNCHES == launches + 1
    assert got.dtype == x.dtype and got.shape == (*x.shape[:3], w.shape[3])
    return got


# one shape of each level of chip_smoke.K1_LEVELS (the 256 px forward's
# segments) at batch 2, every dilation of the level: (C, H = W, d)
K1_LEVEL_SHAPES = [(32, 256, d) for d in (1, 3, 15, 31)] + \
    [(64, 128, d) for d in (1, 3, 15, 31)] + [(128, 64, d) for d in (1, 3, 15)]


# the wide tier's C = 256 segments (chip_smoke.WIDE_LEVELS) at batch 1:
# 32^2 (the 256 px forward and step), 64^2 (512 px), 128^2 (1024 px)
K1_WIDE_SHAPES = [(256, 32, d) for d in (1, 3, 15)] + [(256, 64, 15),
                                                      (256, 128, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,d", K1_LEVEL_SHAPES + K1_WIDE_SHAPES)
def test_k1_level_shapes_match_plain(cuda, C, S, d):
    """The main path's shapes and the wide tier's C = 256 take the TMA
    kernel and agree with the plain version at _k1_close's bf16 limits."""
    assert C in convseg.K1_CHANNELS and convseg.K1_DESIGN == "tma_wgmma"
    x, a, b, w, bias = _inputs(2 if C < 256 else 1, S, S, C, C + d, cuda)
    x = x.to(torch.bfloat16)
    got = _k1_call(x, a, b, w, bias, d)
    _k1_close(got, convseg.bn_act_conv_reference(x, a, b, w, bias,
                                                 dilation=d),
              torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("N,H,W,C,d", [(1, 6, 40, 32, 3),     # ragged W
                                       (3, 5, 7, 64, 1),      # H*W < a tile
                                       (2, 8, 64, 128, 2),    # the 2 x 64 tile
                                       (2, 8, 8, 32, 8),      # d >= H, W
                                       (1, 12, 64, 64, 31),   # d >= H, halo
                                       (1, 4, 128, 32, 70),   # a box per tap
                                       (1, 3, 130, 128, 4),   # W > 128
                                       (1, 5, 40, 256, 3)])   # N in halves
def test_k1_edge_shapes_match_plain(cuda, N, H, W, C, d, act, dtype):
    """Tiles the image does not fill, the per-tap boxes (W <= 32, BW + 2d >
    256), dilations past the image, with b > 0 so that act(b) != 0 where a
    mask from TMA's zero fill (x = 0) would leak it, against the plain
    version at _k1_close's limits."""
    x, a, b, w, bias = _inputs(N, H, W, C, C + d, cuda)
    x, b = x.to(dtype), b.abs() + 0.3
    got = _k1_call(x, a, b, w, bias, d, act)
    _k1_close(got, convseg.bn_act_conv_reference(x, a, b, w, bias,
                                                 dilation=d, act=act), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [32, 64, 128])
def test_k1_zero_padding_is_of_z_not_of_act_b(cuda, C):
    """The card twin of test_torch_convseg's test, exact: x = 0, b = 0.5 and
    w = 1 into output channel 0 give C/2 for each tap inside the image, so
    4 taps at a corner, 6 on an edge, 9 inside (small integers times 0.5:
    exact in bf16 and f32)."""
    x = torch.zeros(1, 8, 8, C, device=cuda)
    a = torch.ones(C, device=cuda)
    b = torch.full((C,), 0.5, device=cuda)
    w = torch.zeros(3, 3, C, C, device=cuda)
    w[..., 0] = 1.0
    y = _k1_call(x, a, b, w, torch.zeros(C, device=cuda), 1)
    assert y[0, 0, 0, 0].item() == 4 * C * 0.5
    assert y[0, 0, 4, 0].item() == 6 * C * 0.5
    assert y[0, 4, 4, 0].item() == 9 * C * 0.5
    assert torch.count_nonzero(y[..., 1:]).item() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [32, 64, 128, 256, 512])
def test_k1_is_deterministic(cuda, C, dtype):
    """Two calls on the same inputs give bit-identical y: each output is
    summed by one warpgroup in a fixed order."""
    x, a, b, w, bias = _inputs(2, 24, 40, C, C, cuda)
    x = x.to(dtype)
    first = _k1_call(x, a, b, w, bias, 3)
    second = _k1_call(x, a, b, w, bias, 3)
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("N,S,d", [(4, 16, 1),    # RB(512) at 16^2
                                   (2, 16, 3),
                                   (3, 4, 1),     # a tile larger than the image
                                   (1, 4, 2)])
def test_k1_c512_on_the_tma_kernel_matches_plain(cuda, N, S, d, act, dtype):
    """C = 512, the wide eval tier's RB(512), on the TMA-fed wgmma kernel
    (N in four 128-channel quarters), one launch a call, with b > 0 so that
    a mask from TMA's zero fill would show, at _k1_close's limits."""
    x, a, b, w, bias = _inputs(N, S, S, 512, 512 + d, cuda)
    x, b = x.to(dtype), b.abs() + 0.3
    got = _k1_call(x, a, b, w, bias, d, act)
    _k1_close(got, convseg.bn_act_conv_reference(x, a, b, w, bias,
                                                 dilation=d, act=act), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("C,Cout", [(64, 32), (32, 128), (512, 256),
                                    (384, 384)])
def test_k1_raises_on_channels_it_does_not_take(cuda, C, Cout):
    """C != Cout and C outside convseg.K1_CHANNELS raise ValueError before
    any launch."""
    x, a, b, _, _ = _inputs(1, 8, 8, C, C, cuda)
    w = torch.zeros((3, 3, C, Cout), device=cuda)
    launches = convseg.LAUNCHES
    with pytest.raises(ValueError, match="K1 takes"):
        convseg.bn_act_conv(x, a, b, w, torch.zeros(Cout, device=cuda),
                            dilation=1)
    assert convseg.LAUNCHES == launches


@pytest.mark.gpu
def test_model_on_card_matches_cpu_plain_path(cuda):
    """64 px, f32, TF32 off: 44 launches per forward; the card's seg
    probabilities within 5e-3 of the CPU plain path's (K1 rounds z to bf16
    on both; the f32 activations feeding it differ in their last bits)."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    model = ResUnetA(5, img_size=64, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    with torch.inference_mode():
        want = model(x)
        with convseg.no_tf32():
            model.to(cuda)
            launches = convseg.LAUNCHES
            got = model(x.to(cuda))
            torch.cuda.synchronize()
    assert convseg.LAUNCHES - launches == 44
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=5e-3)


# ------------------------------------------------------------ K2 backward

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,H,W,C,d", [(2, 32, 32, 32, 31),
                                       (2, 16, 16, 128, 15),
                                       (3, 24, 40, 64, 3),
                                       (1, 64, 64, 32, 1)])
def test_k2_matches_plain(cuda, N, H, W, C, d, dtype):
    """dx, dW and [S1, S2, dc]: only the order of the f32 sums differs. dx
    in f32 within 1e-4 of its largest magnitude; in bf16 a one-ulp flip of
    the final rounding (2^-7 relative). dW and the sums within 1e-4 of
    their largest magnitude."""
    args = _k2_args(N, H, W, C, d, dtype, cuda)
    launches = convseg.BWD_LAUNCHES
    got = convseg.segment_bwd(*args, dilation=d)
    torch.cuda.synchronize()
    assert convseg.BWD_LAUNCHES == launches + 4     # dgrad, wgrad, 2 sums
    want = convseg.segment_bwd_reference(*args, dilation=d)
    assert got[0].dtype == dtype and got[1].shape == (3, 3, C, C)
    _k2_close(got, want, dtype)


def _k2_args(N, H, W, C, d, dtype, device):
    x, a, b, w, _ = _inputs(N, H, W, C, C + d, device)
    rng = np.random.default_rng(d)
    g = torch.from_numpy(rng.standard_normal((N, H, W, C)).astype(
        np.float32)).to(device, dtype)
    mean = torch.from_numpy(rng.standard_normal(C).astype(np.float32) * 0.1
                            ).to(device)
    invstd = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)
                              ).to(device)
    return x.to(dtype), g, a, b, mean, invstd, w


def _k2_close(got, want, dtype):
    """dx: 1e-4 of its largest magnitude, plus one bf16 ulp (2^-7
    relative) of a bf16 dx; dW and the sums: 1e-4 of their largest
    magnitude (only the order of the f32 sums differs)."""
    for k, (gt, wt) in enumerate(zip(got, want)):
        gt, wt = gt.float(), wt.float()
        scale = wt.abs().max().item()
        rtol = 2 ** -7 if (k == 0 and dtype == torch.bfloat16) else 0
        torch.testing.assert_close(gt, wt, rtol=rtol, atol=1e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("N,H,W,d", [(2, 32, 32, 1), (1, 64, 64, 3),
                                     (1, 128, 128, 15)])
def test_k9_matches_plain(cuda, N, H, W, d, act, dtype):
    """K9, the C = 256 backward, at the wide tier's three train planes
    (32², 64², 128²) with and without the ReLU, against the plain version
    at _k2_close's limits: 4 launches a call, counted as K2's and as the
    wide tier's."""
    args = _k2_args(N, H, W, 256, d, dtype, cuda)
    launches, wide = convseg.BWD_LAUNCHES, convseg.WIDE_BWD_LAUNCHES
    got = convseg.segment_bwd(*args, dilation=d, act=act)
    torch.cuda.synchronize()
    assert convseg.BWD_LAUNCHES == launches + 4
    assert convseg.WIDE_BWD_LAUNCHES == wide + 4
    assert got[0].dtype == dtype and got[1].shape == (3, 3, 256, 256)
    want = convseg.segment_bwd_reference(*args, dilation=d, act=act)
    _k2_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,d", [(32, 1), (64, 3), (128, 15)])
def test_k2_without_act_matches_plain(cuda, C, d, dtype):
    """act = False (the dense tail's head segments): no ReLU mask, zb =
    bf16(z_pre); at _k2_close's limits."""
    args = _k2_args(2, 32, 32, C, d, dtype, cuda)
    wide = convseg.WIDE_BWD_LAUNCHES
    got = convseg.segment_bwd(*args, dilation=d, act=False)
    torch.cuda.synchronize()
    assert convseg.WIDE_BWD_LAUNCHES == wide
    want = convseg.segment_bwd_reference(*args, dilation=d, act=False)
    _k2_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [32, 64, 128, 256])
def test_k2_is_deterministic(cuda, C, dtype):
    """Two calls on the same inputs give bit-identical dx, dW and [S1, S2,
    dc]: no atomics, every sum in a fixed order."""
    args = _k2_args(2, 24, 40, C, 3, dtype, cuda)
    first = convseg.segment_bwd(*args, dilation=3)
    second = convseg.segment_bwd(*args, dilation=3)
    torch.cuda.synchronize()
    for f, s in zip(first, second):
        assert torch.equal(f, s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("N,H,W,C,d", [(3, 5, 7, 32, 1),      # H*W < a tile
                                       (1, 3, 130, 64, 2),    # W > 128
                                       (2, 9, 33, 128, 4),    # ragged tiles
                                       (2, 8, 8, 32, 8),      # d >= H
                                       (1, 12, 20, 64, 31),   # d >= H, W
                                       (1, 16, 16, 128, 16),
                                       (3, 5, 7, 256, 1),     # K9: H*W < a tile
                                       (2, 9, 33, 256, 4),    # W % BW != 0
                                       (1, 3, 80, 256, 2),    # 1 x 128 overhang
                                       (1, 12, 20, 256, 31),  # d >= H, W
                                       (1, 4, 64, 256, 100),  # BW + 2d > 256
                                       (1, 2, 128, 256, 70)])
def test_k2_edge_shapes_match_plain(cuda, N, H, W, C, d, act, dtype):
    """Pixel counts that are no multiple of the 128-pixel tile, an image
    smaller than one tile, and dilations past the image (only the centre
    tap sees data) against the plain version at _k2_close's limits; still
    4 launches a call. At C = 256 (K9) also tiles that overhang W and
    halo boxes wider than TMA's 256 columns (a box a tap at W >= 64)."""
    args = _k2_args(N, H, W, C, d, dtype, cuda)
    launches = convseg.BWD_LAUNCHES
    got = convseg.segment_bwd(*args, dilation=d, act=act)
    torch.cuda.synchronize()
    assert convseg.BWD_LAUNCHES == launches + 4
    want = convseg.segment_bwd_reference(*args, dilation=d, act=act)
    _k2_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,d", [(32, 256, 31), (64, 128, 15),
                                   (128, 64, 3)])
def test_k2_main_path_shapes_match_plain(cuda, C, S, d):
    """One shape of each level of the 256 px train step, at batch 2, bf16,
    against the plain version at _k2_close's limits."""
    args = _k2_args(2, S, S, C, d, torch.bfloat16, cuda)
    got = convseg.segment_bwd(*args, dilation=d)
    torch.cuda.synchronize()
    want = convseg.segment_bwd_reference(*args, dilation=d)
    _k2_close(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("C,d", [(32, 15), (128, 1), (256, 3)])
def test_bwdonly_segment_matches_plain(cuda, C, d):
    """K10, the mode-"2" segment, f32, TF32 off, through autograd on the
    card (a cuDNN forward, K2/K9 backward) against its plain version on the
    same card inputs (the same forward; K2's plain version and
    fold_cotangents): y and the seven gradients at _k2_close's f32
    limits. (Against the CPU, a = γ·rsqrt(var + eps) differs in its last
    bit on some channels, CUDA's rsqrt not being correctly rounded, and
    flips bf16 roundings of z: the step tests hold that.)"""
    x, _, _, w, bias = _inputs(2, 32, 32, C, C + d, cuda)
    rng = np.random.default_rng(C + d)
    gamma, beta, mean = (torch.from_numpy(rng.standard_normal(C).astype(
        np.float32) * s + o).to(cuda) for s, o in ((0.3, 1.0), (0.2, 0.0),
                                                   (0.1, 0.0)))
    var = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)
                           ).to(cuda)
    cot = torch.from_numpy(rng.standard_normal((2, 32, 32, C)).astype(
        np.float32)).to(cuda)
    leaves = [t.clone().requires_grad_() for t in
              (x, gamma, beta, mean, var, w, bias)]
    before = convseg.BWDONLY_LAUNCHES
    with convseg.no_tf32():
        y = convseg.fused_segment(*leaves, dilation=d, bwd_only=True)
        got = [y] + list(torch.autograd.grad(y, leaves, cot))
        torch.cuda.synchronize()
        assert convseg.BWDONLY_LAUNCHES == before + 4
        a, b, invstd = convseg.segment_affine(gamma, beta, mean, var)
        want = [convseg.bwdonly_forward(x, a, b, w, bias, dilation=d),
                *convseg.fold_cotangents(*convseg.segment_bwd_reference(
                    x, cot, a, b, mean, invstd, w, dilation=d), gamma,
                    invstd)]
    _k2_close([t.detach() for t in got], want, torch.float32)


# ---------------------------------------------------- K5 and K6, labels

def _blob_planes(n, size, classes, seed):
    """n * classes one-hot int32 planes of Voronoi blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size[0], :size[1]]
    ids = np.empty((n,) + size, np.int64)
    for k in range(n):
        pts = rng.uniform(0, max(size), (12, 2))
        d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
        ids[k] = rng.integers(0, classes, 12)[np.argmin(d2, axis=-1)]
    p = np.eye(classes, dtype=np.int32)[ids].transpose(0, 3, 1, 2)
    return p.reshape((-1,) + size)


def _label_planes(size, seed):
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(np.concatenate([
        _blob_planes(2, size, 5, seed),
        (rng.random((3,) + size) < 0.5).astype(np.int32),
        (rng.random((2,) + size) < 0.03).astype(np.int32),
        np.zeros((1,) + size, np.int32), np.ones((1,) + size, np.int32)]))


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(64, 64), (128, 128), (256, 256), (48, 80)])
@pytest.mark.parametrize("op", ["k5", "k6"])
def test_label_kernels_are_bit_identical(cuda, op, size):
    p = torch.from_numpy(_label_planes(size, sum(size))).to(cuda)
    mod = distance if op == "k5" else boundary
    fn, ref = ((distance.distance_transform_edt,
                distance.distance_transform_edt_reference) if op == "k5"
               else (boundary.boundary_label,
                     boundary.boundary_label_reference))
    launches = mod.LAUNCHES
    got = fn(p)
    torch.cuda.synchronize()
    # the EDT: these planes fit a cluster's shared memory, one launch;
    # Canny: pass 1 and pass 2
    assert mod.LAUNCHES == launches + (1 if op == "k5" else boundary.PASSES)
    assert torch.equal(got, ref(p))
    assert torch.equal(got.cpu(), ref(p.cpu()))


# K7 and K8: (plane shape, tile; None for the wrapper's default on planes
# above the whole-plane limits): bands cut short by the plane's edge, one
# band, several, the default at 512^2 (K8) and 800^2 (K7)
K8_CASES = [((64, 64), 16), ((48, 80), 7), ((200, 96), 40), ((40, 40), 64),
            ((512, 512), None)]
K7_CASES = [((64, 64), 4), ((48, 80), 5), ((13, 40), 3), ((40, 40), 64),
            ((800, 800), None)]


@pytest.mark.gpu
@pytest.mark.parametrize("op,case", [("k8", c) for c in range(len(K8_CASES))]
                         + [("k7", c) for c in range(len(K7_CASES))])
def test_tiled_label_kernels_are_bit_identical(cuda, op, case):
    """K8 and the EDT kernels against their plain versions (the same band
    decomposition) and the whole-plane plain versions, on the card; small
    planes also against the CPU's plain version. K8: one launch, no
    whole-plane launch; the EDT (a `tile` forces design "tail"): the
    leading pass and the steps above distance.TAIL banded, the rest in
    one cluster launch, as `distance.plan` counts them."""
    size, tile = (K8_CASES if op == "k8" else K7_CASES)[case]
    p = torch.from_numpy(_label_planes(size, sum(size))).to(cuda)
    mod = boundary if op == "k8" else distance
    if op == "k8":
        fn, ref, whole = (boundary.boundary_label,
                          boundary.boundary_label_tiled_reference,
                          boundary.boundary_label_reference)
        used = tile or boundary.default_tile(*size)
        n = boundary.PASSES
    else:
        fn, ref, whole = (distance.distance_transform_edt,
                          distance.distance_transform_edt_tiled_reference,
                          distance.distance_transform_edt_reference)
        used = tile or distance.default_tile(size[1])
        n = distance.plan(*size, tile=tile)["launches"]
    counters = ("LAUNCHES", "TILED_LAUNCHES") if op == "k8" else (
        "LAUNCHES",)
    before = [getattr(mod, c) for c in counters]
    got = fn(p, tile=tile)
    torch.cuda.synchronize()
    assert [getattr(mod, c) - b for c, b in zip(counters, before)] == (
        [0, n] if op == "k8" else [n])
    assert torch.equal(got, ref(p, used))
    assert torch.equal(got, whole(p))
    if tile is not None:
        assert torch.equal(got.cpu(), ref(p.cpu(), used))


@pytest.mark.gpu
def test_forced_tiled_kernels_match_the_whole_plane_kernels(cuda):
    """At 256^2, the train step's 256 px planes: K8 forced through `tile`
    equals K6, and the EDT at other tiles equals the EDT at its default."""
    p = torch.from_numpy(_label_planes((256, 256), 7)).to(cuda)
    for tile in (64, 128):
        assert torch.equal(boundary.boundary_label(p, tile=tile),
                           boundary.boundary_label(p))
    for tile in (1, 4, 16):
        assert torch.equal(distance.distance_transform_edt(p, tile=tile),
                           distance.distance_transform_edt(p))


def _extreme_planes(size, seed):
    """int32 planes of values near +-2^31 (Sobel's sums wrap) and of
    uniform ones."""
    rng = np.random.default_rng(seed)
    ext = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 2,
                    2 ** 31 - 1], np.int64)
    return np.concatenate([
        rng.choice(ext, (2,) + size).astype(np.int32),
        rng.integers(-2 ** 31, 2 ** 31, (1,) + size).astype(np.int32)])


# Canny's planes: the K6 size of the 256 px step, K8's of the 512 and
# 1024 px steps (their default tiles), and ragged ones under a pass-1 tile
CANNY_SIZES = [((256, 256), None), ((512, 512), None), ((1024, 1024), None),
               ((48, 80), None), ((33, 65), 16), ((5, 7), None),
               ((1, 50), None), ((40, 1), None)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(CANNY_SIZES)))
def test_canny_pass1_is_bit_identical_and_flags_nothing(cuda, case):
    """K6 / K8 on the card (pass 1, then pass 2, which returns at once):
    bit for bit against the plain versions on class, noise and wrapping
    planes; pass 1 flags no plane (no int32 plane has a weak pixel)."""
    size, tile = CANNY_SIZES[case]
    p = torch.from_numpy(np.concatenate([
        _label_planes(size, case), _extreme_planes(size, case)])).to(cuda)
    got = boundary.boundary_label(p, tile=tile)
    assert torch.equal(got, boundary.boundary_label_reference(p))
    tiled = tile is not None or size[0] * size[1] > boundary.MAX_PLANE_ELEMS
    used = (tile or boundary.default_tile(*size)) if tiled else None
    if tiled:
        assert torch.equal(got, boundary.boundary_label_tiled_reference(
            p, used))
    # the same launch through the C entry, its flags read back
    P, H, W = p.shape
    out = torch.empty_like(got)
    flags = torch.full((P,), 7, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = (p.data_ptr(), out.data_ptr(), flags.data_ptr(), P, H, W)
    rc = boundary._kernel("canny_boundary_tiled")(
        *args, used, boundary.HALO, boundary.HYSTERESIS_ITERS, stream) \
        if tiled else boundary._kernel("canny_boundary")(
            *args, boundary.HYSTERESIS_ITERS, stream)
    torch.cuda.synchronize()
    assert rc == 0 and not flags.any()
    assert torch.equal(out, got)


@pytest.mark.gpu
@pytest.mark.parametrize("size,tile", [((256, 256), None), ((48, 80), None),
                                       ((512, 512), 128), ((200, 96), 40)])
def test_canny_pass2_on_every_plane_gives_pass1s_bits(cuda, size, tile):
    """`boundary.hysteresis` launches pass 2 alone with every plane
    flagged: it computes each plane again (Sobel, NMS, the rounds the
    integer planes skip, the dilation; K6's whole plane or K8's bands) and
    writes the same bits as pass 1; with no plane flagged it writes
    nothing."""
    p = torch.from_numpy(np.concatenate([
        _label_planes(size, 3), _extreme_planes(size, 3)])).to(cuda)
    first = boundary.boundary_label(p, tile=tile)
    P = p.shape[0]
    out = torch.full_like(first, 5.0)
    counter = "TILED_LAUNCHES" if tile else "LAUNCHES"
    launches = getattr(boundary, counter)
    boundary.hysteresis(p, out, torch.zeros(P, dtype=torch.int32,
                                            device=cuda), tile=tile)
    torch.cuda.synchronize()
    assert bool((out == 5.0).all())
    got = boundary.hysteresis(p, out, torch.ones(P, dtype=torch.int32,
                                                 device=cuda), tile=tile)
    torch.cuda.synchronize()
    assert getattr(boundary, counter) == launches + 2
    assert torch.equal(got, first)


# the EDT's layouts on the train steps' planes: the default, every design
# and tile the wrapper can be forced to, and the cluster sizes and fused
# tails of the module constants the layout follows (ops/distance.py
# CLUSTER_SMEM, MAX_CLUSTER, TAIL)
EDT_LAYOUTS = [(256, {}, {}), (256, {}, {"CLUSTER_SMEM": 128 * 1024}),
               (256, {"design": "tail"}, {}),
               (256, {"design": "tail"}, {"TAIL": 16}), (256, {"tile": 4}, {}),
               (512, {}, {}), (512, {}, {"TAIL": 8}), (512, {}, {"TAIL": 16}),
               (512, {}, {"TAIL": 1}), (1024, {}, {}), (1024, {}, {"TAIL": 16}),
               (1024, {}, {"TAIL": 1}),
               (1024, {}, {"TAIL": 8, "MAX_CLUSTER": 4})]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(EDT_LAYOUTS)))
def test_edt_layouts_are_bit_identical(cuda, case, monkeypatch):
    """Bit for bit against the whole-plane plain version on the card, with
    the launches `distance.plan` gives (one for a 256^2 plane in design
    "cluster"; 8 at 512^2 and 9 at 1024^2 by default)."""
    size, kw, consts = EDT_LAYOUTS[case]
    for name, value in consts.items():
        monkeypatch.setattr(distance, name, value)
    p = torch.from_numpy(_label_planes((size, size), size + case)).to(cuda)
    launches = distance.LAUNCHES
    got = distance.distance_transform_edt(p, **kw)
    torch.cuda.synchronize()
    assert distance.LAUNCHES - launches == distance.plan(
        size, size, **kw)["launches"]
    assert torch.equal(got, distance.distance_transform_edt_reference(p))
    if not kw and not consts:
        assert distance.LAUNCHES - launches == {256: 1, 512: 8, 1024: 9}[size]


@pytest.mark.gpu
def test_new_wrappers_raise_instead_of_falling_back(cuda):
    with pytest.raises(ValueError, match="K8"):      # window past 227 KB
        boundary.boundary_label(torch.zeros((1, 400, 4000), dtype=torch.int32,
                                            device=cuda))
    with pytest.raises(ValueError, match="K5/K7"):   # bands past 227 KB
        distance.distance_transform_edt(
            torch.zeros((1, 64, 1024), dtype=torch.int32, device=cuda),
            tile=32)
    with pytest.raises(ValueError, match="K5/K7"):   # 2 MB of seeds
        distance.distance_transform_edt(
            torch.zeros((1, 512, 512), dtype=torch.int32, device=cuda),
            design="cluster")
    for fn in (boundary.boundary_label, distance.distance_transform_edt):
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda),
               tile=0)
    for fn in (boundary.boundary_label, distance.distance_transform_edt):
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 8, 8), device=cuda))          # f32 planes
    x, a, b, w, _ = _inputs(1, 8, 8, 32, 0, cuda)
    with pytest.raises(ValueError):                           # g's dtype
        convseg.segment_bwd(x, x.to(torch.bfloat16), a, b, a, b, w,
                            dilation=1)
    x, a, b, w, _ = _inputs(1, 8, 8, 512, 0, cuda)
    with pytest.raises(ValueError):                           # C = 512
        convseg.segment_bwd(x, x, a, b, a, b, w, dilation=1)


# ------------------------------------------------------------ train step

@pytest.mark.gpu
def test_train_step_on_card_matches_cpu_plain_path(cuda):
    """64 px, bs 2, f32, TF32 off, the dense trunk on both sides, through
    chip_smoke.step_card_vs_cpu (the one copy of this comparison): 44 K1
    launches, 44 K2 calls of 4 launches, 12 K3 calls forward (one launch
    each) and 12 backward (three each), one K4 call each way (the 64 px PSP
    pools only at k = 2; one launch forward, two backward), one EDT call
    of one launch at 64^2 (a whole plane in one cluster) and one K6 call
    of two launches (pass 1, pass 2) per step; the card against the CPU plain path within
    chip_smoke.STEP_TOL (the losses, all gradients, the heads, the last
    decoder ResBlock's leaves that K2 gives, the Combine_5 and PSPPooling_1
    leaves that K3 and K4 give, and every BN running buffer)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    got = chip_smoke.step_card_vs_cpu()
    assert got["launches"] == {"K1": 44, "K2": 4 * 44, "K3": 12,
                               "K3_bwd": 3 * 12, "K4": 1, "K4_bwd": 2,
                               "K5/K7": 1, "K6": 2, "K9": 0, "K10": 0}
    assert not got["failed"], (got["card_vs_cpu"], got["tolerance"])


# the opt-in modes' 64 px steps (ResUnetA arguments) and their launches
# a step: bwd_wide adds the 12 RB(256) segments to K1 and K2 (K9); segment
# mode "2" runs no K1 and the NHWC routing (no K3, K4); tail mode "1" adds
# the five head segments
MODE_STEPS = {
    "bwd_wide": ({"bwd_wide": True},
                 {"K1": 56, "K2": 4 * 56, "K3": 12, "K3_bwd": 3 * 12,
                  "K4": 1, "K4_bwd": 2, "K5/K7": 1, "K6": 2, "K9": 4 * 12,
                  "K10": 0}),
    "segment_mode_2": ({"segment_mode": "2"},
                       {"K1": 0, "K2": 4 * 44, "K3": 0, "K3_bwd": 0,
                        "K4": 0, "K4_bwd": 0, "K5/K7": 1, "K6": 2,
                        "K9": 0, "K10": 4 * 44}),
    "dense_tail_1": ({"dense_tail": "1"},
                     {"K1": 49, "K2": 4 * 49, "K3": 12, "K3_bwd": 3 * 12,
                      "K4": 1, "K4_bwd": 2, "K5/K7": 1, "K6": 2, "K9": 0,
                      "K10": 0}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODE_STEPS))
def test_mode_train_step_on_card_matches_cpu_plain_path(cuda, mode):
    """Each opt-in mode's 64 px, bs 2, f32 step (dense_trunk=True, which
    segment mode "2" turns off), card against the CPU plain path, through
    chip_smoke.step_card_vs_cpu at chip_smoke.STEP_TOL; the launches of
    MODE_STEPS."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    modes, launches = MODE_STEPS[mode]
    got = chip_smoke.step_card_vs_cpu(threads=False, **modes)
    assert got["launches"] == launches
    assert not got["failed"], (got["card_vs_cpu"], got["tolerance"])


@pytest.mark.gpu
def test_train_step_512px_on_card(cuda):
    """One 512 px dense-trunk step at full width (bf16, batch 2, through
    chip_smoke.train_steps): 44 K1 launches, 44 K2 calls of 4, 12 K3 and 3
    K4 calls each way, and on the label side one EDT call of 8 launches
    (design "tail": 7 banded passes, one fused tail) and one K8 call (pass
    1 and pass 2), no K6; finite metric rows."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from resuneta_torch import models

    counts, rows, _, _, params = chip_smoke.train_steps(
        models, 1, None, (convseg, densemm, poolconv, distance, boundary),
        patch=512, batch=2)
    assert counts == chip_smoke.expected_counts(1, True, 512)
    assert counts["K5/K7"] == 8 and counts["K8"] == boundary.PASSES
    assert counts["K6"] == 0
    assert np.isfinite(rows).all() and params == 42708930


# ---------------------------------------------------------------- K3, K4

# (parts as (cin, h, w, act, ups, stride), cout, N): the main path's kinds
# at small sizes: a strided downsample, a Combine with ReLU and a x2 fold,
# the PSP projection with ups 1/2/4/8, narrow and wide outputs
K3_CASES = [
    ([(32, 16, 16, False, 1, 2)], 64, 2),
    ([(128, 16, 16, False, 1, 2)], 256, 1),
    ([(256, 8, 8, False, 1, 1)], 64, 2),
    ([(16, 8, 8, True, 2, 1), (32, 16, 16, False, 1, 1)], 32, 2),
    ([(32, 16, 16, True, 1, 1), (32, 16, 16, False, 1, 1)], 32, 2),
    ([(32, 32, 32, False, 1, 1)], 8, 1),
    ([(8, 32, 32, False, 1, 1), (8, 16, 16, False, 2, 1),
      (8, 8, 8, False, 4, 1), (8, 4, 4, False, 8, 1),
      (32, 32, 32, False, 1, 1)], 32, 2),
]


def _k3_inputs(parts, cout, N, dtype, seed, device):
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal((N, h, w, c)).astype(
        np.float32)).to(device, dtype) for c, h, w, _, _, _ in parts]
    cin = sum(p[0] for p in parts)
    w = torch.from_numpy((rng.standard_normal((cin, cout)) / cin ** 0.5
                          ).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) *
                            0.1).to(device)
    spec = {"acts": [p[3] for p in parts], "ups": [p[4] for p in parts],
            "strides": [p[5] for p in parts]}
    return xs, w, bias, spec


def _close(got, want, out_rtol):
    """Within out_rtol relative (one bf16 ulp of a bf16 result, 0 for
    f32) plus 1e-3 of the largest magnitude (bf16) or 1e-5 (f32): the
    plain versions repeat the kernels' roundings, only the order of the
    f32 sums differs."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    atol = (1e-3 if out_rtol else 1e-5) * scale
    torch.testing.assert_close(got, want, rtol=out_rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", range(len(K3_CASES)))
def test_k3_matches_plain(cuda, case, dtype):
    parts, cout, N = K3_CASES[case]
    xs, w, bias, spec = _k3_inputs(parts, cout, N, dtype, case, cuda)
    launches = densemm.LAUNCHES
    y = densemm.dense_mm_fwd(xs, w, bias, **spec)
    torch.cuda.synchronize()
    assert densemm.LAUNCHES == launches + 1
    assert y.dtype == dtype
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 0
    _close(y, densemm.dense_mm_reference(xs, w, bias, **spec), ulp)

    g = torch.randn(y.shape, device=cuda).to(dtype)
    launches = densemm.BWD_LAUNCHES
    dxs, dw, db = densemm.dense_mm_bwd(xs, g, w, **spec)
    torch.cuda.synchronize()
    assert densemm.BWD_LAUNCHES == launches + densemm.bwd_launches(
        dtype, spec["ups"])
    wdxs, wdw, wdb = densemm.dense_mm_bwd_reference(xs, g, w, **spec)
    for dx, wdx, (_, _, _, _, _, s) in zip(dxs, wdxs, parts):
        _close(dx, wdx, ulp)
        if s > 1:      # zero where the strided conv does not read
            assert not dx[:, 1::2].any() and not dx[:, :, 1::2].any()
    _close(dw, wdw, 0)
    _close(db, wdb, 0)


def _tied(N, H, W, C, seed, device, dtype):
    """Small integers: exact ties in most windows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (N, H, W, C)).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_k4_matches_plain(cuda, k, dtype, tied):
    N, H, W, C, cout = 2, 32, 32, 32, 8
    if tied:
        x = _tied(N, H, W, C, k, cuda, dtype)
    else:
        x = torch.randn((N, H, W, C), device=cuda).to(dtype)
    w = torch.randn((C, cout), device=cuda) / C ** 0.5
    bias = torch.randn(cout, device=cuda) * 0.1
    launches = poolconv.LAUNCHES
    y = poolconv.pool_conv_fwd(x, w, bias, k=k)
    torch.cuda.synchronize()
    assert poolconv.LAUNCHES == launches + 1
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 0
    _close(y, poolconv.pool_conv_reference(x, w, bias, k=k), ulp)
    g = torch.randn(y.shape, device=cuda).to(dtype)
    launches = poolconv.BWD_LAUNCHES
    got = poolconv.pool_conv_bwd(x, g, w, k=k)
    torch.cuda.synchronize()
    # one pass over (x, g), then the fixed-order sum of the partials
    assert poolconv.BWD_LAUNCHES == launches + 2
    want = poolconv.pool_conv_bwd_reference(x, g, w, k=k)
    for i, (gt, wt) in enumerate(zip(got, want)):
        _close(gt, wt, ulp if i == 0 else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_k4_main_path_shape_is_deterministic(cuda, k, dtype):
    """The PSP's calls at 256 px (16 x 256^2 x 32 -> cout 8) with planted
    ties: within the tolerance of the plain version, and a repeated
    backward bit-identical (fixed-order sums, no atomics)."""
    x = _tied(16, 256, 256, 32, k, cuda, dtype)
    w = torch.randn((32, 8), device=cuda) / 32 ** 0.5
    g = torch.randn((16, 256 // k, 256 // k, 8), device=cuda).to(dtype)
    got = poolconv.pool_conv_bwd(x, g, w, k=k)
    again = poolconv.pool_conv_bwd(x, g, w, k=k)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 0
    want = poolconv.pool_conv_bwd_reference(x, g, w, k=k)
    for i, (gt, wt) in enumerate(zip(got, want)):
        _close(gt, wt, ulp if i == 0 else 0)


@pytest.mark.gpu
def test_k3_k4_raise_instead_of_falling_back(cuda):
    xs, w, bias, spec = _k3_inputs([(32, 8, 8, False, 1, 1)], 32, 1,
                                   torch.bfloat16, 0, cuda)
    with pytest.raises(ValueError):                           # w on the CPU
        densemm.dense_mm_fwd(xs, w.cpu(), bias, **spec)
    with pytest.raises(ValueError):                           # cin = 12
        densemm.dense_mm_fwd([xs[0][..., :12].contiguous()], w[:12], bias)
    with pytest.raises(ValueError):                           # cout = 12
        densemm.dense_mm_fwd(xs, w[:, :12], bias[:12])
    with pytest.raises(ValueError):                           # g's dtype
        densemm.dense_mm_bwd(xs, torch.zeros((1, 8, 8, 32), device=cuda),
                             w, **spec)
    x = torch.zeros((1, 8, 8, 32), device=cuda)
    with pytest.raises(ValueError):                           # k = 3
        poolconv.pool_conv_fwd(x, w[:, :8].contiguous(), bias[:8], k=3)
    with pytest.raises(ValueError):                           # NCHW strides
        poolconv.pool_conv_fwd(x.permute(0, 3, 1, 2), w[:, :8], bias[:8],
                               k=2)
    x64 = torch.zeros((1, 8, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="K4"):               # C = 64
        poolconv.pool_conv_bwd(x64, torch.zeros((1, 4, 4, 8), device=cuda),
                               torch.zeros((64, 8), device=cuda), k=2)


@pytest.mark.gpu
def test_wrappers_raise_off_the_current_device(cuda, monkeypatch):
    """Each kernel's wrapper raises, and launches nothing, where its
    tensors are not on the current device (the kernels query and set the
    current device's attributes): here the current device is made to read
    as another card."""
    x, a, b, w, bias = _inputs(1, 8, 8, 32, 0, cuda)
    xs, w3, bias3, spec = _k3_inputs([(32, 8, 8, False, 1, 1)], 32, 1,
                                     torch.bfloat16, 0, cuda)
    planes = torch.zeros((2, 16, 16), dtype=torch.int32, device=cuda)
    g4 = torch.zeros((1, 4, 4, 8), device=cuda)
    w4 = torch.zeros((32, 8), device=cuda)
    calls = [
        lambda: convseg.bn_act_conv(x, a, b, w, bias, dilation=1),
        lambda: convseg.segment_bwd(x, x, a, b, a, b, w, dilation=1),
        lambda: densemm.dense_mm_fwd(xs, w3, bias3, **spec),
        lambda: densemm.dense_mm_bwd(xs, torch.zeros_like(xs[0]), w3,
                                     **spec),
        lambda: poolconv.pool_conv_fwd(x, w4, bias[:8], k=2),
        lambda: poolconv.pool_conv_bwd(x, g4, w4, k=2),
        lambda: distance.distance_transform_edt(planes),
        lambda: boundary.boundary_label(planes),
        lambda: boundary.hysteresis(
            planes, torch.zeros((2, 16, 16), device=cuda),
            torch.ones(2, dtype=torch.int32, device=cuda))]
    counts = [(convseg, "LAUNCHES"), (convseg, "BWD_LAUNCHES"),
              (densemm, "LAUNCHES"), (densemm, "BWD_LAUNCHES"),
              (poolconv, "LAUNCHES"), (poolconv, "BWD_LAUNCHES"),
              (distance, "LAUNCHES"), (boundary, "LAUNCHES")]
    before = [getattr(m, k) for m, k in counts]
    other = torch.cuda.current_device() + 1
    monkeypatch.setattr(torch.cuda, "current_device", lambda: other)
    for call in calls:
        with pytest.raises(ValueError, match="current device"):
            call()
    monkeypatch.undo()
    assert [getattr(m, k) for m, k in counts] == before
    convseg.bn_act_conv(x, a, b, w, bias, dilation=1)     # and it launches
    torch.cuda.synchronize()
    assert convseg.LAUNCHES == before[0] + 1


@pytest.mark.gpu
def test_two_ranks_on_the_card_match_one_process(cuda, tmp_path):
    """chip_smoke.dist_compare (the chip smoke's dist phase at 256 px in
    bf16) at 64 px in f32: two gloo ranks sharing the card, 2 rows each of
    a global batch of 4, 2 SGD steps of the dense-trunk multitask d6 with
    K1-K6 live on each rank, against the same steps in this process on the
    4 rows: the rows, the updates and the BN buffers within
    chip_smoke.STEP_TOL's limits, the ranks' parameters bit for bit, each
    rank's launches those of 2 steps."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    got = chip_smoke.dist_compare("gloo", tmp_path / "dist", patch=64,
                                  batch=4, steps=2, dtype=torch.float32)
    assert not got["failed"], (got["failed"], got["readings"],
                               got["limits"])
    assert got["launches_a_rank"] == chip_smoke.expected_counts(
        2, True, 64, f32=True)


@pytest.mark.gpu
def test_space_step_on_the_card_matches_one_process(cuda, tmp_path):
    """chip_smoke's space phase at 64 px in f32: two gloo ranks share the
    card as a 1 x 2 (data, space) mesh, each with the 4 rows' band of 32
    rows, 2 SGD steps with K1-K4 off (halos and gathers through the
    host), against the same steps in this process inside
    convseg.disabled(): the readings within chip_smoke.STEP_TOL's limits,
    the ranks bit for bit, each rank's launches the labels' alone."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    got = chip_smoke.dist_compare("gloo", tmp_path / "space", patch=64,
                                  batch=4, steps=2, dtype=torch.float32,
                                  mesh_shape=(1, 2))
    assert not got["failed"], (got["failed"], got["readings"],
                               got["limits"])
    assert got["launches_a_rank"] == chip_smoke.expected_counts(
        2, False, 64, segments=0)


@pytest.mark.gpu
def test_halo_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """parallel.axis.halo on CUDA bands of two gloo ranks sharing the card
    (through the host): each band's halo is the zero-padded plane's rows,
    d = 31 wider than the 16-row band, and the bands' gradients those of
    the padded plane."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_dist_ranks
    from resuneta_torch.parallel import launch

    rows = (1, 3, 31)
    planes = np.random.default_rng(0).standard_normal(
        (2, 3, 32, 5)).astype(np.float32)
    launch.spawn(torch_dist_ranks.card_halo, 2, (launch.rendezvous(
        str(tmp_path)), str(tmp_path), planes, rows), timeout_s=240)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    x = torch.tensor(planes, requires_grad=True)
    for d in rows:
        xp = torch.nn.functional.pad(x, (0, 0, d, d))
        for j in range(2):
            y = xp[:, :, j * 16:j * 16 + 16 + 2 * d]
            assert torch.equal(got[j]["halo"][d], y.detach()), (d, j)
            (y * y).sum().backward()
    torch.testing.assert_close(torch.cat([g["grad"] for g in got], dim=2),
                               x.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_xprof_device_ms_is_positive_and_within_the_wall(cuda):
    """utils.xprof on the card: the device ms a step of a matmul chain is
    positive and at most the wall ms a step around the capture."""
    import time

    from resuneta_torch.utils import xprof

    a = torch.randn(2048, 2048, device=cuda)

    def step():
        b = a
        for _ in range(8):
            b = b @ a
        return b

    step()
    torch.cuda.synchronize()
    t0 = time.time()
    ms = xprof.capture_device_ms(step, 5, torch.cuda.synchronize)
    wall_ms = (time.time() - t0) * 1e3 / 5
    assert ms is not None and 0 < ms <= wall_ms, (ms, wall_ms)


# --------------------------------------------- K3's Hopper kernels (bf16)

def _k3_path_case(i, N):
    """chip_smoke.K3_CALLS[i] at batch N: (parts as (cin, h, w, act, ups,
    stride), cout)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    _, parts, cout = chip_smoke.K3_CALLS[i]
    return [(c, h, h, a, k, s) for c, h, a, k, s in parts], cout


def _k3_run(xs, w, bias, spec, g):
    y = densemm.dense_mm_fwd(xs, w, bias, **spec)
    got = densemm.dense_mm_bwd(xs, g, w, **spec)
    torch.cuda.synchronize()
    return y, got


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(12))
def test_k3_path_shapes_match_plain(cuda, i):
    """Each of the 256 px step's 12 calls at full width (batch 16, bf16)
    through the Hopper kernels against the plain versions, every dx (a
    strided part's zeros exactly), dW and dbias."""
    parts, cout = _k3_path_case(i, 16)
    xs, w, bias, spec = _k3_inputs(parts, cout, 16, torch.bfloat16, i, cuda)
    assert densemm.k3_design(xs[0].dtype) == "tma_wgmma"
    H = parts[0][1] // parts[0][5] * parts[0][4]
    g = torch.randn((16, H, H, cout), device=cuda).to(torch.bfloat16)
    y, (dxs, dw, db) = _k3_run(xs, w, bias, spec, g)
    _close(y, densemm.dense_mm_reference(xs, w, bias, **spec), 2 ** -7)
    wdxs, wdw, wdb = densemm.dense_mm_bwd_reference(xs, g, w, **spec)
    for dx, wdx, p in zip(dxs, wdxs, parts):
        _close(dx, wdx, 2 ** -7)
        if p[5] > 1:
            assert not dx[:, 1::2].any() and not dx[:, :, 1::2].any()
    # dW and dbias: f32 sums over up to 10^6 pixels in another order than
    # the plain version's matmul: within 1e-4 of the largest magnitude
    # (chip_smoke.py holds the same calls to 1e-3; the PSP projection's
    # plain part reads 1.9e-5 on an H100)
    for got, want in ((dw, wdw), (db, wdb)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())


# ragged shapes: W not a power of two (a tile overhangs), H * W under a
# tile, a strided part with the ReLU, cout padded to the next wgmma width
K3_RAGGED = [
    ([(16, 10, 20, True, 2, 1), (24, 20, 40, False, 1, 1)], 40, 1),
    ([(8, 24, 40, True, 1, 2)], 24, 2),
    ([(32, 3, 5, False, 1, 1)], 8, 3),
    ([(72, 12, 48, False, 1, 1), (8, 3, 12, True, 4, 1)], 136, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(K3_RAGGED)))
def test_k3_ragged_shapes_match_plain(cuda, case):
    parts, cout, N = K3_RAGGED[case]
    xs, w, bias, spec = _k3_inputs(parts, cout, N, torch.bfloat16, 50 + case,
                                   cuda)
    _, h, w_, _, k, st = parts[0]
    H, W = h // st * k, w_ // st * k
    g = torch.randn((N, H, W, cout), device=cuda).to(torch.bfloat16)
    y, (dxs, dw, db) = _k3_run(xs, w, bias, spec, g)
    _close(y, densemm.dense_mm_reference(xs, w, bias, **spec), 2 ** -7)
    wdxs, wdw, wdb = densemm.dense_mm_bwd_reference(xs, g, w, **spec)
    for dx, wdx in zip(dxs, wdxs):
        _close(dx, wdx, 2 ** -7)
    _close(dw, wdw, 0)
    _close(db, wdb, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("i", [0, 4, 11])
def test_k3_backward_is_deterministic(cuda, i):
    """Two runs of the backward on the same inputs give bitwise-equal dx,
    dW and dbias (per-block partials summed in a fixed order)."""
    parts, cout = _k3_path_case(i, 4)
    xs, w, bias, spec = _k3_inputs(parts, cout, 4, torch.bfloat16, i, cuda)
    H = parts[0][1] // parts[0][5] * parts[0][4]
    g = torch.randn((4, H, H, cout), device=cuda).to(torch.bfloat16)
    a = _k3_run(xs, w, bias, spec, g)
    b = _k3_run(xs, w, bias, spec, g)
    assert torch.equal(a[0], b[0])
    for x, z in zip(a[1][0], b[1][0]):
        assert torch.equal(x, z)
    assert torch.equal(a[1][1], b[1][1]) and torch.equal(a[1][2], b[1][2])


@pytest.mark.gpu
def test_k3_f32_stays_on_pr3_kernels_and_bf16_limits_raise(cuda):
    """f32 runs PR 3's kernels (design "pr3", the same launches); a bf16
    call the Hopper kernels refuse raises instead of running another."""
    assert densemm.k3_design(torch.float32) == "pr3"
    xs, w, bias, spec = _k3_inputs([(32, 8, 8, False, 1, 1)], 264, 1,
                                   torch.float32, 0, cuda)
    n = densemm.LAUNCHES
    densemm.dense_mm_fwd(xs, w, bias, **spec)                 # f32: cout 264
    assert densemm.LAUNCHES == n + 1
    with pytest.raises(ValueError, match="refuse"):           # bf16: cout 264
        densemm.dense_mm_fwd([xs[0].bfloat16()], w, bias, **spec)
    xs, w, bias, spec = _k3_inputs([(32, 4, 4, False, 2, 1)], 32, 1,
                                   torch.bfloat16, 0, cuda)
    with pytest.raises(ValueError, match="refuse"):           # all upsampled
        densemm.dense_mm_fwd(xs, w, bias, **spec)
    with pytest.raises(ValueError, match="refuse"):
        densemm.dense_mm_bwd(xs, torch.zeros((1, 8, 8, 32), device=cuda,
                                             dtype=torch.bfloat16), w, **spec)


# ----------------------------------------------------------- train runtime

@pytest.mark.gpu
def test_train_cli_packed_then_resume_on_card(cuda, tmp_path):
    """The packed dataset -> train CLI -> resume path at 64 px, f32, full
    width (chip_smoke.train_cli: 2 patches with the 5 variants, 8 train
    and 2 validation samples, batch 4, 2 epochs, then 1 epoch from the
    best checkpoint at lr 5e-4; the restored state bit for bit, the
    resumed lr and step). The native row gather serves the batches, and
    the kernels launch per train step as the 64 px step does (44 K1, 44
    K2 calls of 4, 12 K3 calls (1 launch forward, 3 backward), 1 K4 call
    (1, 2), 1 EDT launch, 2 Canny launches) and per eval step 44 K1 and the
    labels' 1 + 2."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    out = chip_smoke.train_cli(
        tmp_path, (convseg, densemm, poolconv, distance, boundary),
        patch=64, batch=4, patches=2, dtype="float32")
    assert out["loader"] == "native"
    for name, epochs in (("run", 2), ("resume", 1)):
        r = out[name]
        t, e = r["train_steps"], r["eval_steps"]
        assert (t, e) == (2 * epochs, epochs)
        want = dict.fromkeys(r["counts"], 0)
        want.update({"K1": 44 * (t + e), "K2": 4 * 44 * t, "K2 calls": 44 * t,
                     "K3": 12 * t, "K3 calls": 12 * t, "K3 bwd": 36 * t,
                     "K3 bwd calls": 12 * t, "K4": t, "K4 calls": t,
                     "K4 bwd": 2 * t, "K4 bwd calls": t, "K5/K7": t + e,
                     "K6": 2 * (t + e)})
        assert r["counts"] == want, name


@pytest.mark.gpu
def test_dataset_batches_reach_the_card_as_the_cpu_bytes(cuda, tmp_path):
    """A packed batch (native row gather) through the step's moves and the
    device pipeline: the uint8 pixels, ids and variants on the card are
    the host's bytes; the one-hot and boundary labels equal the CPU
    pipeline's bit for bit; the normalised image within one f32 ulp
    (2^-23 relative: PyTorch's CUDA division by a scalar multiplies by the
    reciprocal, the CPU divides); distance and HSV colour within 1e-6
    absolute (values in [0, 1]; the distance's min-max division as the
    image's)."""
    from resuneta_torch.data import (PackedDataset, make_device_pipeline,
                                     native_loader, write_packed_dataset)
    from resuneta_torch.train.steps import _on

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rng = np.random.default_rng(3)
    write_packed_dataset(
        str(tmp_path), rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8),
        chip_smoke.voronoi_ids(3, 64, 5, rng), 5)
    raw = PackedDataset(str(tmp_path)).get_batch([14, 0, 7, 3])
    assert native_loader.backend() == "native"
    moved = _on(raw, cuda)
    for k, v in raw.items():
        assert moved[k].is_cuda and torch.equal(moved[k].cpu(),
                                                torch.as_tensor(v)), k
    card = make_device_pipeline(5, 1, True, device=cuda)(raw)
    cpu = make_device_pipeline(5, 1, True, device="cpu")(raw)
    for k in ("seg", "bound"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    torch.testing.assert_close(card["image"].cpu(), cpu["image"],
                               rtol=2 ** -23, atol=0)
    for k in ("dist", "color"):
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=0, atol=1e-6)


# ------------------------------------------------------------------ Amazon

@pytest.mark.gpu
def test_amazon_train_step_on_card_matches_cpu_plain_path(cuda):
    """The Amazon CLI's step at 64 px, bs 2, f32 (14 bands, 3 classes, no
    colour head, the WCE on seg, bound and dist, make_label_head_pipeline
    on float patches), the dense trunk on both sides, TF32 off, through
    chip_smoke.step_card_vs_cpu(amazon=True): the launches of the ISPRS
    64 px step (f32: K3's backward 3 launches a call) and the card against
    the CPU plain path within chip_smoke.STEP_TOL."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    got = chip_smoke.step_card_vs_cpu(threads=False, amazon=True)
    assert got["launches"] == {"K1": 44, "K2": 4 * 44, "K3": 12,
                               "K3_bwd": 3 * 12, "K4": 1, "K4_bwd": 2,
                               "K5/K7": 1, "K6": 2, "K9": 0, "K10": 0}
    assert not got["failed"], (got["card_vs_cpu"], got["tolerance"])


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(12))
def test_amazon_k3_f32_128px_shapes_match_plain(cuda, i):
    """Each of the 128 px Amazon step's 12 K3 calls (chip_smoke.k3_calls,
    batch 8, f32: the CUDA-core tiles, "pr3") against the plain version: y and
    every dx within 1e-5 of the largest magnitude, dW and dbias within
    1e-4 (f32 sums over up to 1.3 10^5 pixels in another order), a strided
    part's dx zero where the conv does not read; the backward 3 launches."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    _, parts, cout = chip_smoke.k3_calls(128)[i]
    parts = [(c, h, h, a, k, s) for c, h, a, k, s in parts]
    xs, w, bias, spec = _k3_inputs(parts, cout, 8, torch.float32, i, cuda)
    assert densemm.k3_design(xs[0].dtype) == "pr3"
    H = parts[0][1] // parts[0][5] * parts[0][4]
    g = torch.randn((8, H, H, cout), device=cuda)
    launches = densemm.BWD_LAUNCHES
    y, (dxs, dw, db) = _k3_run(xs, w, bias, spec, g)
    assert densemm.BWD_LAUNCHES == launches + 3
    _close(y, densemm.dense_mm_reference(xs, w, bias, **spec), 0)
    wdxs, wdw, wdb = densemm.dense_mm_bwd_reference(xs, g, w, **spec)
    for dx, wdx, p in zip(dxs, wdxs, parts):
        _close(dx, wdx, 0)
        if p[5] > 1:
            assert not dx[:, 1::2].any() and not dx[:, :, 1::2].any()
    for got, want in ((dw, wdw), (db, wdb)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_amazon_k4_f32_128px_matches_plain(cuda, k):
    """The 128 px Amazon step's PSP levels (8 x 128^2 x 32 -> cout 8, f32)
    with planted ties: y, dx, dW and dbias within 1e-5 of the largest
    magnitude, and a repeated backward bit-identical."""
    x = _tied(8, 128, 128, 32, k, cuda, torch.float32)
    w = torch.randn((32, 8), device=cuda) / 32 ** 0.5
    bias = torch.randn(8, device=cuda) * 0.1
    y = poolconv.pool_conv_fwd(x, w, bias, k=k)
    _close(y, poolconv.pool_conv_reference(x, w, bias, k=k), 0)
    g = torch.randn(y.shape, device=cuda)
    got = poolconv.pool_conv_bwd(x, g, w, k=k)
    again = poolconv.pool_conv_bwd(x, g, w, k=k)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = poolconv.pool_conv_bwd_reference(x, g, w, k=k)
    for gt, wt in zip(got, want):
        _close(gt, wt, 0)


# ----------------------------------------------- the rest of the family

@pytest.mark.gpu
def test_v1_eval_segments_on_card_match_cpu_plain_path(cuda):
    """ResUnetAV1 (multitask, 64 px, f32) in eval: its 44 segments
    (ResBlockV1: ResBlockA without the identity path) through K1 on the
    card, against the CPU's K1 plain version, TF32 off: every head within
    chip_smoke.SEG_ATOL (the slice phase's card-vs-CPU limit)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from resuneta_torch.models import ResUnetAV1

    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    model = ResUnetAV1(5, img_size=64, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model(x)
        model.to(cuda)
        launches = convseg.LAUNCHES
        with convseg.no_tf32():
            got = model(x.to(cuda))
        torch.cuda.synchronize()
    assert convseg.LAUNCHES - launches == 44
    for k, v in want.items():
        err = (got[k].cpu() - v).abs().max().item()
        assert err <= chip_smoke.SEG_ATOL, (k, err)


@pytest.mark.gpu
def test_legacy_train_step_on_card_matches_cpu_plain_path(cuda):
    """ResUnetALegacy's 64 px, bs 2, f32 step (Adam 1e-3, single-task
    Tanimoto): its 32 train segments through K1 and K2 on the card against
    their plain versions on the CPU, through
    chip_smoke.legacy_step_card_vs_cpu at chip_smoke.LEGACY_STEP_TOL
    (STEP_TOL's limits, the last block's set by the legacy model's own
    order-of-sums noise, as STEP_TOL's was by the d6's)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    got = chip_smoke.legacy_step_card_vs_cpu()
    assert got["launches"] == {"K1": 32, "K2 calls": 32}
    assert not got["failed"], (got["card_vs_cpu"], got["tolerance"])


@pytest.mark.gpu
def test_remat_step_on_card_launches_and_matches_cpu(cuda):
    """make_train_step(remat=True) at 64 px, bs 2, f32 on the dense trunk:
    the checkpointed blocks' forwards run again in the backward, so 88 K1
    launches, 21 K3 calls forward and 2 K4 forwards, the rest as the
    step without remat; the card against the CPU plain path with remat
    (which equals the CPU step without it bit for bit,
    tests/test_torch_remat.py) within chip_smoke.STEP_TOL."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    got = chip_smoke.step_card_vs_cpu(threads=False, remat=True)
    assert got["launches"] == {"K1": 88, "K2": 4 * 44, "K3": 21,
                               "K3_bwd": 3 * 12, "K4": 2, "K4_bwd": 2,
                               "K5/K7": 1, "K6": 2, "K9": 0, "K10": 0}
    assert not got["failed"], (got["card_vs_cpu"], got["tolerance"])
