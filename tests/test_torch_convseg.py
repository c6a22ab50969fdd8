"""K1, the fused BN affine -> ReLU -> dilated 3x3 conv segment of the PyTorch
port (resuneta_torch/ops/convseg.py), against the Pallas kernel it replaces
(resuneta_tpu/ops/pallas/convseg.py) run in interpret mode on the CPU.

Inputs are drawn with numpy and handed to both frameworks. Both sides round
z = x*a + b once to f32 (XLA contracts it to a fused multiply-add; the port
defines z so), then to bf16, so only the order of the f32 sums differs.
Tolerance: max abs error <= 1e-3 on f32 outputs of magnitude up to ~20
(observed <= 2e-5); it leaves room for a rare one-ulp bf16 flip of z."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from resuneta_torch.ops import convseg
from resuneta_tpu.ops.pallas import convseg as jconvseg

ATOL = 1e-3


def _inputs(N, H, W, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    a = (rng.standard_normal(C) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.2).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, a, b, w, bias


CASES = [(2, 32, 32, C, d) for C in (32, 64, 128) for d in (1, 3, 15)] + \
    [(1, 64, 64, 32, 31)] + \
    [(1, 16, 16, 512, 1), (1, 8, 8, 512, 3)]   # the wide eval tier's RB(512)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("N,H,W,C,d", CASES)
def test_plain_matches_pallas_interpret(N, H, W, C, d, act):
    x, a, b, w, bias = _inputs(N, H, W, C, seed=1000 * C + d)
    want = np.asarray(jconvseg.bn_act_conv_pallas(
        *map(jnp.asarray, (x, a, b, w, bias)), dilation=d, act=act,
        interpret=True))
    calls, launches = convseg.CALLS, convseg.LAUNCHES
    got = convseg.bn_act_conv(*map(torch.from_numpy, (x, a, b, w, bias)),
                              dilation=d, act=act)
    assert got.dtype == torch.float32 and got.shape == (N, H, W, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # a CPU tensor takes the plain version: counted as a call, not a launch
    assert convseg.CALLS == calls + 1 and convseg.LAUNCHES == launches


def test_bf16_input_keeps_dtype():
    """bf16 x: z is formed from the same values, so the bf16 result is the
    f32-input result rounded once to bf16."""
    x, a, b, w, bias = _inputs(1, 16, 16, 32, seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = [torch.from_numpy(t) for t in (a, b, w, bias)]
    y16 = convseg.bn_act_conv(xb, *args, dilation=3)
    y32 = convseg.bn_act_conv(xb.float(), *args, dilation=3)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.to(torch.bfloat16))


def test_zero_padding_is_of_z_not_of_act_b():
    """Outside the image z is 0, not act(b): with x = 0 and w = 1 the output
    at a corner sums act(b) over the 4 taps inside the image only."""
    C = 32
    x = torch.zeros(1, 8, 8, C)
    a = torch.ones(C)
    b = torch.full((C,), 0.5)
    w = torch.zeros(3, 3, C, C)
    w[..., 0] = 1.0
    y = convseg.bn_act_conv(x, a, b, w, torch.zeros(C), dilation=1)
    assert y[0, 0, 0, 0].item() == pytest.approx(4 * C * 0.5)
    assert y[0, 4, 4, 0].item() == pytest.approx(9 * C * 0.5)


@pytest.mark.parametrize("bad", ["channels", "layout", "weight", "dilation",
                                 "c_ne_cout", "c384"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """On every device, before any launch: K1 takes C == Cout in
    convseg.K1_CHANNELS only (C = 16, Cout = 64 != C, C = 384 raise)."""
    C = 384 if bad == "c384" else 32
    x, a, b, w, bias = (torch.from_numpy(t)
                        for t in _inputs(1, 8, 8, C, seed=3))
    d = 1
    if bad == "channels":
        x, a, b = x[..., :16], a[:16], b[:16]
        w = w[:, :, :16].contiguous()
    elif bad == "layout":
        x = x.permute(0, 2, 1, 3)
    elif bad == "weight":
        w = w[:, :, :, :16]
    elif bad == "c_ne_cout":
        w, bias = torch.cat([w, w], dim=3), torch.cat([bias, bias])
    elif bad == "dilation":
        d = 0
    with pytest.raises(ValueError):
        convseg.bn_act_conv(x.contiguous() if bad != "layout" else x,
                            a, b, w, bias, dilation=d)


def test_routing_predicate_is_the_reference_eval_gate():
    assert convseg.available(256, 32, 32)
    assert convseg.available(16, 128, 128)
    assert not convseg.available(32, 256, 256)   # K9 wide tier: opt-in there
    assert not convseg.available(64, 32, 64)     # C != Cout
    assert not convseg.available(2, 32, 32)      # (W*C) % 128 != 0


# the model's segment levels: (C, the patch's divisor at that level)
LEVELS = ((32, 1), (64, 2), (128, 4), (256, 8), (512, 16), (1024, 32))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("bwd", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("P", [64, 256, 512, 1024])
def test_gate_admits_the_reference_channel_set(P, bwd, wide, monkeypatch):
    """The (C, W) pairs the gate admits at each patch's levels are the
    reference's pallas_available with RESUNETA_CONVSEG_{BWD,FWD}_WIDE set
    as `wide` says, its TPU-backend and VMEM-plan checks taken out: the
    narrow tier C in {32, 64, 128}; the wide one adds C = 256 for training
    and C = 256, 512 for eval; C = 1024 never."""
    monkeypatch.setattr(jconvseg.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jconvseg, "_plan_tile", lambda *a, **k: 8)
    monkeypatch.setenv("RESUNETA_CONVSEG_BWD_WIDE" if bwd else
                       "RESUNETA_CONVSEG_FWD_WIDE", "1" if wide else "0")
    admitted = [C for C, k in LEVELS
                if convseg.available(P // k, C, C, bwd=bwd, wide=wide)]
    assert admitted == [C for C, k in LEVELS if jconvseg.pallas_available(
        P // k, P // k, C, C, 1, bwd=bwd)]
    assert admitted == [32, 64, 128] + ([256] if wide else []) + \
        ([512] if wide and not bwd else [])


def test_wide_gate_runs_k9_where_the_reference_has_no_plan():
    """Without the plan check the routes part at 1024 px: the reference's
    planner finds no VMEM plan for the C = 256 train segments at 128^2 and
    runs XLA's conv there; the port's gate sends them to K1 + K9 (the same
    function). At 256 and 512 px both route them to the wide kernels."""
    for d in (1, 3, 15):
        assert jconvseg._plan_tile(128, 128, 256, d, bwd=True) is None
        for S in (32, 64):
            assert jconvseg._plan_tile(S, S, 256, d, bwd=True) is not None
    assert convseg.available(128, 256, 256, wide=True)


def _tile_emulation(x, a, b, w, bias, d, act):
    """convseg.cu's tma_fwd_kernel decomposition in plain torch: tiles of
    PIX pixels (BW = the power of two >= W up to PIX, BH = PIX / BW, as
    sm90::make_geo); with the halo (BW >= 64, BW + 2d <= 256) one box per
    stencil row ky, BH rows x (BW + 2d) columns from (h0 + (ky-1)d, w0 - d),
    read with zero fill (TMA's: x = 0 outside), z formed once from it and
    masked to 0 on the box's image coordinates, flattened to rows of
    pixels, and a warpgroup's 64 pixels for tap kx read from row
    arow + kx*d; else one box per tap, the tile shifted by it. A work item
    is (tile, NI output channels) (FwdShape PIX, NI, NSPLIT): up to C =
    256 128 pixels x all C channels or (C = 256) one of two 128-channel
    halves, warpgroup wg on pixels [64 wg, 64 wg + 64); at C = 512 64
    pixels x one of two 256-channel halves, both warpgroups on the item's
    z, warpgroup wg on its channels [128 wg, 128 wg + 128). Each item forms
    its own z. The bias is added in f32 and the overhang masked."""
    N, H, W, C = x.shape
    PIX = 64 if C == 512 else 128
    NT = C if C < 256 else 128
    NI = 2 * NT if C == 512 else NT
    bw_log2 = 0
    while (1 << bw_log2) < W and (2 << bw_log2) <= PIX:
        bw_log2 += 1
    BW, BH = 1 << bw_log2, PIX >> bw_log2
    halo = BW >= 64 and BW + 2 * d <= 256
    # (first pixel, first channel of the item) of each warpgroup's part
    parts = [(0, 0), (0, NT)] if C == 512 else [(0, 0), (64, 0)]
    wb = w.to(torch.bfloat16).float()
    y = torch.zeros(N, H, W, w.shape[3])

    def z_box(n, h_org, w_org, cols):
        hh = torch.arange(BH)[:, None] + h_org
        ww = torch.arange(cols)[None, :] + w_org
        inside = (hh >= 0) & (hh < H) & (ww >= 0) & (ww < W)
        raw = x[n, hh.clamp(0, H - 1), ww.clamp(0, W - 1)] * inside[..., None]
        z = (raw.double() * a.double() + b.double()).float()
        z = torch.relu(z) if act else z
        z = torch.where(inside[..., None], z, torch.zeros(()))
        return z.to(torch.bfloat16).float().reshape(BH * cols, C)

    for n in range(N):
        for h0 in range(0, H, BH):
            for w0 in range(0, W, BW):
                for n0 in range(0, C, NI):
                    acc = torch.zeros(PIX, NI)
                    for ky in range(3):
                        h_org = h0 + (ky - 1) * d
                        if halo:
                            box_w = BW + 2 * d
                            z = z_box(n, h_org, w0 - d, box_w)
                            for px, ch in parts:
                                arow = (px >> bw_log2) * box_w + (px & (BW - 1))
                                wq = wb[ky, :, :, n0 + ch:n0 + ch + NT]
                                for kx in range(3):
                                    rows = z[arow + kx * d:arow + kx * d + 64]
                                    acc[px:px + 64, ch:ch + NT] += rows @ wq[kx]
                        else:
                            for kx in range(3):
                                z = z_box(n, h_org, w0 + (kx - 1) * d, BW)
                                acc += z @ wb[ky, kx, :, n0:n0 + NI]
                    r = torch.arange(PIX)
                    hh, ww = h0 + (r >> bw_log2), w0 + (r & (BW - 1))
                    keep = (hh < H) & (ww < W)
                    y[n, hh[keep], ww[keep], n0:n0 + NI] = \
                        acc[keep] + bias.float()[n0:n0 + NI]
    return y.to(x.dtype)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("N,H,W,C,d", [
    (1, 4, 40, 32, 3),     # ragged W: a 2 x 64 tile overhangs by 24
    (1, 4, 64, 64, 1),     # W = 64: the 2 x 64 tile
    (1, 3, 130, 32, 2),    # W > 128: 1 x 128 tiles, the second ragged
    (1, 3, 64, 32, 31),    # d >= H: the rows of the box outside the image
    (2, 5, 7, 32, 8),      # H*W under a tile, W <= 32: a box per tap
    (1, 2, 128, 32, 70),   # BW + 2d > 256: a box per tap
    (1, 16, 16, 512, 1),   # RB(512) at 16^2: 4 x 16 tiles, N in halves
    (1, 16, 16, 512, 3),
    (1, 4, 4, 512, 1),     # a 16 x 4 tile larger than the image
    (1, 4, 4, 512, 2),
    (1, 2, 64, 512, 2),    # the halo at C = 512: 1 x 64 tiles
])
def test_tile_algorithm_matches_reference(N, H, W, C, d, act):
    """The kernel's tiling, halo boxes, image mask and tap offsets, emulated
    in plain torch, equal the plain version: b > 0 so that act(b) != 0 and
    a mask taken from TMA's zero fill (x = 0) would show. Only the order of
    the f32 sums differs (the products of bf16 values are exact in f32)."""
    x, a, b, w, bias = (torch.from_numpy(t)
                        for t in _inputs(N, H, W, C, seed=10 * W + d))
    b = b.abs() + 0.3
    got = _tile_emulation(x, a, b, w, bias, d, act)
    want = convseg.bn_act_conv_reference(x, a, b, w, bias, dilation=d,
                                         act=act)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_k1_design_routes_by_channels():
    """One design, the TMA-fed wgmma kernel, takes C == Cout in {32, 64,
    128, 256, 512} (convseg_forward refuses the rest); the wrapper's check
    admits exactly those, and C != Cout is refused at every C."""
    assert convseg.K1_DESIGN == "tma_wgmma"
    assert convseg.K1_CHANNELS == (32, 64, 128, 256, 512)
    # _tile_emulation's work items (FwdShape PIX x NI)
    assert convseg.K1_ITEMS == {C: (64 if C == 512 else 128,
                                    256 if C == 512 else min(C, 128))
                                for C in convseg.K1_CHANNELS}
    z = torch.zeros(1)
    for C in (32, 64, 96, 128, 256, 384, 512, 1024):
        for cout in (C, 2 * C):
            args = (torch.zeros(1, 4, 4, C), z.expand(C), z.expand(C),
                    torch.zeros(3, 3, C, cout), z.expand(cout))
            if C in convseg.K1_CHANNELS and cout == C:
                convseg._check(*args, 1)
            else:
                with pytest.raises(ValueError, match="K1 takes"):
                    convseg._check(*args, 1)
