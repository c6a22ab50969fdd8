"""The Hopper designs of the EDT kernel (K5/K7, kernels/csrc/jfa.cu) and of
K4's one-pass backward (kernels/csrc/poolconv.cu), emulated in torch on
the CPU and held to the plain versions bit for bit (the EDT) or within
their tolerance (K4).

The EDT: `plan` gives the kernels' layout, and `_emulate_edt` runs it as
the kernels do: the banded passes (the first forms its seeds from the
input as it stages it), then one cluster launch: per band of rows, a
window of halo rows a side split into per-rank slabs of R rows, two
buffers each, every candidate row read from the slab of its owner (the
distributed shared-memory read), each pass computing the band and the
rows a side that later passes read, "no seed" packed as a far point. It
asserts that no computed row reads a row that is not exact, that each
row's distance is written once, and that a pixel which is its own seed
keeps it (the kernels skip its weighing). The rows of every slab are
emulated at once, so the file stays cheap. K4: `_emulate_k4_bwd` runs the backward's blocks (G * k
threads a pooled pixel, a grid-stride loop, per-thread dW/dbias
accumulators, the block's fixed-order sum into its partial row) and the
fixed-order reduce over the rows.
"""

import numpy as np
import pytest
import torch

from resuneta_torch.ops import distance, poolconv

FAR = 0x6000
NONE = (FAR << 16) | FAR


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulations are many small ops: one thread runs them fastest,
    and keeps them fast when the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _d2(s, i, jj):
    return (i - (s >> 16)) ** 2 + (jj - (s & 0xFFFF)) ** 2


def _pass_rows(rows, ii, s, W):
    """jfa.cu's gather and pick over rows ii at once: rows[a] the (n, P, W)
    pass-start seeds of rows ii + (a - 1) * s (NONE outside the plane),
    columns outside the plane none, the reference's candidate order and
    strict <. Returns (seeds, d2s)."""
    jj = torch.arange(W, dtype=torch.int32)
    i = ii[:, None, None]
    seed = rows[1].clone()
    best = _d2(seed, i, jj)
    ok = {-1: jj >= s, 0: torch.ones(W, dtype=torch.bool), 1: jj + s < W}
    for a in range(3):
        for b in (-1, 0, 1):
            if a == 1 and b == 0:
                continue
            ns = rows[a][..., (jj + b * s).clamp(0, W - 1)]
            cand = _d2(ns, i, jj)
            take = ok[b] & (cand < best)
            seed = torch.where(take, ns, seed)
            best = torch.where(take, cand, best)
    # a pixel that is its own seed keeps it: the kernels skip its weighing
    own = rows[1] == ((i << 16) | jj)
    assert torch.equal(seed[own], rows[1][own])
    return seed, best


def _seeds_of(inp, g):
    """The seeds of the int32 rows g of inp, formed as they are staged."""
    jj = torch.arange(inp.shape[-1], dtype=torch.int32)
    return torch.where(inp != 0, torch.full_like(inp, NONE),
                       (g[:, None, None] << 16) | jj)


def _banded(planes, lay):
    """jfa_pass over the leading lay["nbanded"] steps, the first from the
    input: whole-plane Jacobi passes with NONE beyond the plane (the band
    decomposition itself is K7's, which tests/test_torch_labels_tiled.py
    holds)."""
    P, H, W = planes.shape
    ii = torch.arange(H, dtype=torch.int32)
    cur = _seeds_of(planes.transpose(0, 1), ii)     # (H, P, W)
    for s in lay["steps"][:lay["nbanded"]]:
        rows = [distance.shift(cur.transpose(0, 1), d, 0, NONE).transpose(
            0, 1) for d in (-s, 0, s)]
        cur = _pass_rows(rows, ii, s, W)[0]
    return cur.transpose(0, 1)


def _cluster(src, from_input, lay):
    """One jfa_cluster launch: per band, the window's row g in the slab of
    rank (g - g0) // R, two buffers a slab; every candidate row read from
    its owner's slab (the distributed shared-memory read), the rows of all
    slabs at once. The distances of every row, each written once."""
    P, H, W = src.shape
    cs, R, band, halo = lay["cs"], lay["R"], lay["band"], lay["halo"]
    steps = lay["steps"][lay["nbanded"]:]
    rows_of = src.transpose(0, 1)                    # (H, P, W)
    out = torch.full((H, P, W), float("nan"))
    written = torch.zeros(H, dtype=torch.int64)
    for b0 in range(0, H, band):
        b1 = min(H, b0 + band)
        g0, g1 = max(0, b0 - halo), min(H, b1 + halo)
        assert cs * R >= g1 - g0

        def slab(g):
            """(owner rank, row in its slab) of window rows g."""
            owner = (g - g0).div(R, rounding_mode="floor")
            return owner, g - g0 - owner * R

        # two buffers of R rows a rank, and which rows hold exact seeds
        bufs = torch.full((2, cs, R, P, W), -7, dtype=torch.int32)
        exact = torch.zeros((2, cs, R), dtype=torch.bool)
        g = torch.arange(g0, g1, dtype=torch.int32)
        bufs[0][slab(g)] = _seeds_of(rows_of[g], g) if from_input \
            else rows_of[g]
        exact[0][slab(g)] = True
        rem = halo
        for k, s in enumerate(steps):
            rem = max(rem - s, 0)
            cur, nxt = k & 1, (k & 1) ^ 1
            exact[nxt] = False
            # the rows a side of the band that later passes still read
            ii = torch.arange(max(g0, b0 - rem), min(g1, b1 + rem),
                              dtype=torch.int32)
            rows = []
            for a in (-1, 0, 1):
                gi = ii + a * s
                inside = (gi >= 0) & (gi < H)
                # a row of the plane that the window holds, exact when read
                assert ((gi[inside] >= g0) & (gi[inside] < g1)).all(), (b0, k)
                owner, local = slab(gi)
                assert exact[cur, owner[inside], local[inside]].all(), (b0, k)
                got = bufs[cur, owner.clamp(0, cs - 1), local.clamp(0, R - 1)]
                rows.append(torch.where(inside[:, None, None], got,
                                        torch.full_like(got, NONE)))
            seed, best = _pass_rows(rows, ii, s, W)
            if k == len(steps) - 1:
                d2 = torch.where(seed == NONE, 2 ** 30, best)
                out[ii] = torch.sqrt(d2.double()).float()
                written[ii] += 1
            else:
                bufs[nxt][slab(ii)] = seed
                exact[nxt][slab(ii)] = True
    assert torch.equal(written, torch.ones(H, dtype=torch.int64))
    return out.transpose(0, 1)


def _emulate_edt(planes, **kw):
    lay = distance.plan(*planes.shape[1:], **kw)
    if lay["nbanded"]:
        return _cluster(_banded(planes, lay), False, lay), lay
    return _cluster(planes, True, lay), lay


def _planes(shape, seed):
    """Voronoi blobs (one-hot, ties between equidistant sites), noise,
    sparse zeros, zeros on a grid (ties everywhere), all-zero, all-one."""
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[:H, :W]
    pts = rng.uniform(0, 1, (8, 2)) * shape
    pts[1] = pts[0] + (0, 7)                 # a pair mirrored about a column
    ids = np.argmin((yy[..., None] - pts[:, 0]) ** 2 +
                    (xx[..., None] - pts[:, 1]) ** 2, axis=-1) % 3
    grid = np.ones((H, W), np.int32)
    grid[::6, ::6] = 0
    return torch.from_numpy(np.ascontiguousarray(np.concatenate([
        np.eye(3, dtype=np.int32)[ids].transpose(2, 0, 1),
        (rng.random((1, H, W)) < 0.5).astype(np.int32),
        (rng.random((1, H, W)) < 0.02).astype(np.int32), grid[None],
        np.zeros((1, H, W), np.int32), np.ones((1, H, W), np.int32)])))


# (shape, the wrapper's arguments, the module constants the layout follows)
EDT_CASES = [((64, 64), {}, {}), ((48, 80), {}, {}), ((13, 40), {}, {}),
             ((64, 64), {"design": "tail"}, {}), ((48, 80), {"tile": 5}, {}),
             ((256, 256), {}, {}),
             ((256, 256), {}, {"CLUSTER_SMEM": 128 * 1024}),
             ((256, 256), {"design": "tail"}, {}),
             ((64, 1024), {"design": "tail"}, {"MAX_CLUSTER": 2, "TAIL": 8}),
             ((64, 1024), {"design": "tail"}, {"MAX_CLUSTER": 1})]
# the planes of the large shapes, to keep the file quick: the Voronoi
# planes of the mirrored pair (ties), the grid (ties everywhere), all-zero
# and all-one; the noise, the sparse zeros and the third class run at the
# small shapes
LARGE_PLANES = [0, 1, 5, 6, 7]


def _case_id(case):
    (H, W), kw, consts = case
    return f"{H}x{W}-" + ("-".join(f"{k}{v}" for k, v in {
        **kw, **consts}.items()) or "default")


_SHAPES = {}


def _planes_and_reference(shape):
    """One stack of planes a shape and its whole-plane plain version,
    shared by the cases of that shape."""
    if shape not in _SHAPES:
        p = _planes(shape, sum(shape))
        if shape[0] * shape[1] > 64 * 80:
            p = p[LARGE_PLANES].contiguous()
        _SHAPES[shape] = p, distance.distance_transform_edt_reference(p)
    return _SHAPES[shape]


@pytest.mark.parametrize("case", range(len(EDT_CASES)),
                         ids=[_case_id(c) for c in EDT_CASES])
def test_edt_hopper_decomposition_is_bit_identical(case, monkeypatch):
    """Every design the wrapper can be forced to, at the card-vs-CPU
    step's 64^2, the 256 px step's 256^2 (in clusters of 8 and of 4), a
    non-square plane, and bands with window edges inside the plane (W =
    1024 in clusters of 2 and 1, fused tails of the steps up to 8 and
    4)."""
    shape, kw, consts = EDT_CASES[case]
    for name, value in consts.items():
        monkeypatch.setattr(distance, name, value)
    p, want = _planes_and_reference(shape)
    got, lay = _emulate_edt(p, **kw)
    assert torch.equal(got, want)
    if "CLUSTER_SMEM" in consts:
        assert (lay["design"], lay["cs"]) == ("cluster", 4)
    if shape[1] == 1024:
        assert lay["cs"] == consts["MAX_CLUSTER"]
        assert max(lay["steps"][lay["nbanded"]:]) == consts.get("TAIL", 4)
        assert lay["band"] < shape[0] and lay["halo"] > 0


def test_edt_plan_on_the_main_path():
    """One launch for a 256^2 (and 64^2) plane; 1 + the banded passes (8
    at 512^2, 9 at 1024^2) in design "tail", whose windows fit a block."""
    got = {s: distance.plan(s, s) for s in (64, 256, 512, 1024)}
    assert [(g["design"], g["launches"]) for g in got.values()] == [
        ("cluster", 1), ("cluster", 1), ("tail", 8), ("tail", 9)]
    assert (got[256]["cs"], got[256]["R"]) == (8, 32)
    for s, g in got.items():
        assert 4 * (2 * g["R"] + 1) * s <= distance.SMEM_BYTES
        assert g["cs"] * g["R"] >= min(s, g["band"] + 2 * g["halo"])
    assert got[1024]["steps"][got[1024]["nbanded"]:] == [4, 2, 1, 1]
    with pytest.raises(ValueError):
        distance.plan(512, 512, design="cluster")      # 2 MB of seeds
    with pytest.raises(ValueError):
        distance.plan(8193, 16)


# ------------------------------------------------------------------ K4

def _tree(acc, width):
    """__shfl_xor_sync's butterfly over the last axis in groups of `width`
    lanes (offsets 1, 2, .. width / 2): every lane ends with the group's
    sum, added in the kernel's pairing order."""
    n = acc.shape[-1]
    lanes = torch.arange(n)
    d = 1
    while d < width:
        acc = acc + acc[..., lanes ^ d]
        d <<= 1
    return acc


def _emulate_k4_bwd(x, g, w, k, blocks):
    """poolconv.cu's backward: dx from each window's max, tie count and dz
    (each row thread's share of the outputs o = a (mod k), summed across
    the rows); dW / dbias from per-thread accumulators over a grid-stride
    loop of `blocks` blocks of 256 / (C / 8 * k) pixel slots, two pixels a
    slot a trip at k = 2 and one above, the block's sum
    (the warp's pixel slots by a butterfly, then the warps in order) into
    its row, and the rows summed in 32 strided groups, then the groups in
    order. Returns (dx, dW, dbias, how often each pixel was taken)."""
    N, H, W, C = x.shape
    cout = w.shape[1]
    cd = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    G = C // 8
    tpp = G * k
    ppb = 256 // tpp
    Ho, Wo = H // k, W // k
    M = N * Ho * Wo
    xw = x.float().reshape(N, Ho, k, Wo, k, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(M, k * k, C)
    m = xw.amax(dim=1)                                      # (M, C)
    ties = (xw == m[:, None]).float().sum(dim=1)
    gs = g.reshape(M, cout).to(cd).float()
    wc = w.to(cd).float()
    # dz[c] = sum over row threads a of sum_{o = a mod k} g[o] W[c, o]
    part = torch.stack([gs[:, a::k] @ wc[:, a::k].t() for a in range(k)], -1)
    dz = _tree(part, k)[..., 0]
    dxw = torch.where(xw == m[:, None], (dz / ties)[:, None], 0.0)
    dx = dxw.reshape(N, Ho, Wo, k, k, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(x.shape).to(x.dtype)

    # slot (block b, pixel slot s): in trip t its pixels q = t * stride +
    # b * ppb * npx + p * ppb + s, p < npx (2 at k = 2, else 1), in order
    npx = 2 if k == 2 else 1
    stride = blocks * ppb * npx
    first = (torch.arange(blocks)[:, None] * ppb * npx +
             torch.arange(ppb)[None, :]).reshape(-1)
    acc = torch.zeros((blocks, ppb, C + 1, cout))
    taken = torch.zeros(M, dtype=torch.int64)
    for t, p in [(t, p) for t in range(-(-M // stride)) for p in range(npx)]:
        q = t * stride + p * ppb + first
        live = q < M
        qq = q.clamp(max=M - 1)
        taken.index_add_(0, q[live], torch.ones(int(live.sum()),
                                                dtype=torch.int64))
        prod = torch.cat([m[qq][:, :, None] * gs[qq][:, None, :],
                          gs[qq][:, None, :]], dim=1)
        acc += torch.where(live[:, None, None], prod, 0.0).reshape(
            blocks, ppb, C + 1, cout)
    spw = 32 // tpp                                  # pixel slots a warp
    warps = _tree(acc.reshape(blocks, ppb // spw, spw, C + 1, cout)
                  .movedim(2, -1), spw)[..., 0]
    rows = warps[:, 0]
    for wp in range(1, warps.shape[1]):
        rows = rows + warps[:, wp]
    groups = []
    for ty in range(32):
        s = torch.zeros((C + 1, cout))
        for r in range(ty, blocks, 32):
            s = s + rows[r]
        groups.append(s)
    total = groups[0]
    for s in groups[1:]:
        total = total + s
    return dx, total[:C], total[C], taken


def _k4_blocks(M, C, k):
    """The backward's blocks for M pooled pixels, as poolconv.cu chooses
    them: a trip's worth of pixels a block (256 / (C / 8 * k) slots, two
    pixels a slot at k = 2, one above), at most 4 * 132."""
    per_block = 256 // (C // 8 * k) * (2 if k == 2 else 1)
    return min(4 * 132, -(-M // per_block))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_k4_one_pass_backward_partials_match_plain(k, dtype):
    """Planted ties (half the channels on a grid of 1/4, so most of their
    windows hold their max more than once); the main path's C = 32, cout
    = 8 and C = 16, cout = 16; the kernel's block count and 3 blocks (a
    grid-stride loop of many trips). Each pooled pixel is taken once, and
    dx, dW, dbias are within the card's tolerance of the plain version
    (chip_smoke.TOLERANCE's terms: 1e-3 of the largest magnitude, plus a
    bf16 ulp of a bf16 dx); launches are not counted: no kernel runs."""
    rng = np.random.default_rng(k)
    for N, S, C, cout in ((2, 64, 32, 8), (1, 32, 16, 16)):
        x = rng.standard_normal((N, S, S, C)).astype(np.float32)
        x[..., :C // 2] = np.round(x[..., :C // 2] * 4) / 4
        x = torch.from_numpy(x).to(dtype)
        w = torch.from_numpy((rng.standard_normal((C, cout)) /
                              C ** 0.5).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(
            (N, S // k, S // k, cout)).astype(np.float32)).to(dtype)
        want = poolconv.pool_conv_bwd_reference(x, g, w, k=k)
        for blocks in (_k4_blocks(N * (S // k) ** 2, C, k), 3):
            *got, taken = _emulate_k4_bwd(x, g, w, k, blocks)
            assert torch.equal(taken, torch.ones_like(taken))
            for gt, wt in zip(got, want):
                rtol = 2 ** -7 if gt.dtype == torch.bfloat16 else 0
                torch.testing.assert_close(
                    gt.float(), wt.float(), rtol=rtol,
                    atol=1e-3 * wt.abs().max().item())
