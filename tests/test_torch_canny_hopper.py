"""The Canny boundary kernel's two-pass design (K6/K8,
resuneta_torch/kernels/csrc/canny.cu) emulated in torch on the CPU and held
bit for bit against the plain version, `boundary_label_reference`, which
tests/test_torch_labels.py holds against the JAX package.

Pass 1 works on tiles of boundary.TILE_ROWS x TILE_COLS output pixels, each
from its input with 3 pixels around (clamped into the plane: the replicate
border), with mag 0 outside the plane and no strong pixel there; it writes
the cross dilation of the strong pixels and flags a plane with a weak pixel.
A tile whose input frame holds one value writes 0 without the stencil.
Pass 2 computes the flagged planes again with the hysteresis. On int32
planes no pixel is weak (the parity lemma below), so pass 2 never changes a
plane there; the flag gate is tested with a synthetic weak mask, and
`boundary.hysteresis`, pass 2's wrapper, on the CPU. Torch only: the JAX
package has no tiled Canny of this shape."""

import numpy as np
import pytest
import torch

from resuneta_torch.ops import boundary

I32 = np.iinfo(np.int32)


def _tile_frames(H, W, pad):
    """Global row and column indices of every tile's frame (the tile and
    `pad` pixels around it): (th, TILE_ROWS + 2 pad), (tw, TILE_COLS +
    2 pad)."""
    TH, TW = boundary.TILE_ROWS, boundary.TILE_COLS
    th, tw = -(-H // TH), -(-W // TW)
    rows = torch.arange(th)[:, None] * TH + torch.arange(-pad, TH + pad)
    cols = torch.arange(tw)[:, None] * TW + torch.arange(-pad, TW + pad)
    return rows, cols


def _pass1(planes, weak_extra=None):
    """canny_tile_kernel in torch, every tile at once: (out, flags, strong,
    weak). The arrays are indexed (P, tile row, tile column, r, c) in the
    tile's frames as the kernel's img / mag / edge. A tile whose img frame
    holds one value takes the kernel's shortcut: 0 out, no stencil.
    `weak_extra` (P, H, W) bool adds weak pixels, as a plane that had them
    would."""
    P, H, W = planes.shape
    TH, TW = boundary.TILE_ROWS, boundary.TILE_COLS
    rows, cols = _tile_frames(H, W, 3)
    img = planes[:, rows.clamp(0, H - 1)[:, None, :, None],
                 cols.clamp(0, W - 1)[None, :, None, :]]   # (P, th, tw, IH, IW)

    def win(a, dr, dc):        # the 3x3 window's (dr, dc) neighbour
        R, C = a.shape[-2:]
        return a[..., 1 + dr:R - 1 + dr, 1 + dc:C - 1 + dc]

    dx = (win(img, -1, 1) - win(img, -1, -1)) + \
        2 * (win(img, 0, 1) - win(img, 0, -1)) + \
        (win(img, 1, 1) - win(img, 1, -1))
    dy = (win(img, 1, -1) - win(img, -1, -1)) + \
        2 * (win(img, 1, 0) - win(img, -1, 0)) + \
        (win(img, 1, 1) - win(img, -1, 1))
    mrow, mcol = _tile_frames(H, W, 2)
    inside = ((mrow >= 0) & (mrow < H))[:, None, :, None] & \
        ((mcol >= 0) & (mcol < W))[None, :, None, :]
    mag = torch.where(inside, dx.abs() + dy.abs(), 0)

    dxc, dyc, m = win(dx, 0, 0), win(dy, 0, 0), win(mag, 0, 0)
    x_abs = dxc.abs()
    y_sh = dyc.abs() << 15
    tg22x = x_abs * 13573
    tg67x = tg22x + ((x_abs + x_abs) << 15)
    keep = [(m > win(mag, 0, -1)) & (m >= win(mag, 0, 1)),
            (m > win(mag, -1, 0)) & (m >= win(mag, 1, 0)),
            (m > win(mag, -1, 1)) & (m > win(mag, 1, -1)),
            (m > win(mag, -1, -1)) & (m > win(mag, 1, 1))]
    kept = torch.where(y_sh < tg22x, keep[0], torch.where(
        y_sh > tg67x, keep[1], torch.where((dxc ^ dyc) < 0, keep[2],
                                           keep[3])))
    kept = kept & (m > 0) & win(inside, 0, 0)
    strong, weak = kept & (m > 1), kept & (m == 1)
    erow, ecol = _tile_frames(H, W, 1)
    if weak_extra is not None:
        ext = weak_extra[:, erow.clamp(0, H - 1)[:, None, :, None],
                         ecol.clamp(0, W - 1)[None, :, None, :]]
        weak = weak | (ext & win(inside, 0, 0))
        strong = strong & ~weak
    flags = weak.flatten(1).any(1).to(torch.int32)

    e = win(strong, 0, 0) | win(strong, -1, 0) | win(strong, 1, 0) | \
        win(strong, 0, -1) | win(strong, 0, 1)          # (P, th, tw, TH, TW)
    uniform = (img == img[..., :1, :1]).flatten(-2).all(-1)
    e = e & ~uniform[..., None, None]
    out = e.permute(0, 1, 3, 2, 4).reshape(P, e.shape[1] * TH,
                                          e.shape[2] * TW)[:, :H, :W]
    return out.float().contiguous(), flags, strong, weak


def _untile(a, H, W):
    """A (P, th, tw, TH + 2, TW + 2) array of the edge frames -> (P, H, W):
    each pixel from the tile that owns it."""
    core = a[..., 1:-1, 1:-1]
    P, th, tw, TH, TW = core.shape
    return core.permute(0, 1, 3, 2, 4).reshape(P, th * TH, tw * TW)[:, :H, :W]


def _two_pass(planes, weak_extra=None):
    """Pass 1, then pass 2 on the flagged planes: (out, flags)."""
    out, flags, strong, weak = _pass1(planes, weak_extra)
    H, W = planes.shape[1:]
    for p in flags.nonzero().flatten().tolist():
        edges = boundary._hysteresis(_untile(strong, H, W)[p:p + 1],
                                     _untile(weak, H, W)[p:p + 1])
        out[p] = boundary.cross_dilate(edges)[0]
    return out, flags


def _voronoi(n, H, W, rng, classes=5):
    yy, xx = np.mgrid[:H, :W]
    ids = np.empty((n, H, W), np.int64)
    for k in range(n):
        pts = rng.uniform(0, max(H, W), (8, 2))
        d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
        ids[k] = rng.integers(0, classes, 8)[np.argmin(d2, axis=-1)]
    return np.eye(classes, dtype=np.int32)[ids].transpose(0, 3, 1, 2) \
        .reshape(-1, H, W)


def _planes(kind, H, W, seed):
    rng = np.random.default_rng(seed)
    if kind == "voronoi":
        p = _voronoi(1, H, W, rng)
    elif kind == "noise":
        p = (rng.random((3, H, W)) < 0.5).astype(np.int32)
    elif kind == "zeros":
        p = np.zeros((1, H, W), np.int32)
    elif kind == "ones":
        p = np.ones((1, H, W), np.int32)
    elif kind == "blocks":   # constant blocks of any int32: uniform tiles
        v = rng.integers(I32.min, I32.max, (2, -(-H // 24), -(-W // 40)),
                         dtype=np.int32, endpoint=True)
        p = np.repeat(np.repeat(v, 24, axis=1), 40, axis=2)[:, :H, :W]
    else:   # values near +-2^31: Sobel's sums wrap
        ext = np.array([I32.min, I32.min + 1, I32.min + 2, -1, 0, 1,
                        I32.max - 1, I32.max], np.int32)
        p = np.concatenate([
            rng.choice(ext, (2, H, W)),
            rng.integers(I32.min, I32.max, (2, H, W), dtype=np.int32,
                         endpoint=True)])
    return torch.from_numpy(np.ascontiguousarray(p))


# plane shapes: ragged tiles both ways, planes smaller than a tile, one
# row, one column, one pixel, whole tiles
SHAPES = [(70, 100), (33, 65), (5, 7), (1, 50), (40, 1), (1, 1), (64, 128)]
KINDS = ["voronoi", "noise", "zeros", "ones", "blocks", "extreme"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H,W", SHAPES)
def test_pass1_emulation_matches_reference(H, W, kind):
    """Pass 1's tiling, halo staging, plane-edge masks and arithmetic equal
    the whole-plane plain version bit for bit, and flag no plane."""
    planes = _planes(kind, H, W, seed=31 * H + W)
    out, flags, _, _ = _pass1(planes)
    assert torch.equal(out, boundary.boundary_label_reference(planes))
    assert not flags.any()


def test_pass1_emulation_at_the_train_steps_plane_size():
    """A 256^2 plane set (8 x 4 tiles a plane) of each kind, as the 256 px
    step gives K6, bit for bit; the class planes have tiles of one value,
    which take the shortcut, and tiles across their blobs' edges."""
    planes = torch.cat([_planes(k, 256, 256, seed=5)[:1] for k in KINDS])
    out, flags, _, _ = _pass1(planes)
    assert torch.equal(out, boundary.boundary_label_reference(planes))
    assert not flags.any()
    rows, cols = _tile_frames(256, 256, 3)
    img = planes[:, rows.clamp(0, 255)[:, None, :, None],
                 cols.clamp(0, 255)[None, :, None, :]]
    uniform = (img == img[..., :1, :1]).flatten(-2).all(-1)
    assert 0 < int(uniform[0].sum()) < uniform[0].numel()


def test_flag_gate_takes_the_hysteresis_on_flagged_planes_only():
    """Synthetic weak pixels beside strong edges on planes 1 and 3: pass 1
    flags exactly those; pass 2 gives them the plain hysteresis of (strong,
    weak), which grows edges into the weak pixels, and leaves the other
    planes as pass 1 wrote them."""
    planes = _planes("voronoi", 48, 80, seed=3)[:4].contiguous()
    strong, _ = boundary._strong_weak(planes)
    near = boundary._dilate8(strong) & ~strong
    weak = torch.zeros_like(strong)
    weak[[1, 3]] = near[[1, 3]] & (torch.rand(near[[1, 3]].shape,
                                              generator=torch.Generator()
                                              .manual_seed(0)) < 0.5)
    first, flags, _, _ = _pass1(planes, weak)
    assert flags.tolist() == [0, 1, 0, 1]
    got, _ = _two_pass(planes, weak)
    want = boundary.cross_dilate(boundary._hysteresis(strong & ~weak, weak))
    assert torch.equal(got, want)
    for p in (0, 2):
        assert torch.equal(got[p], first[p])
    for p in (1, 3):       # the hysteresis grew edges: pass 1's is not it
        assert not torch.equal(got[p], first[p])
        assert torch.equal(got[p], want[p])


@pytest.mark.parametrize("tile", [None, 16])
def test_hysteresis_wrapper_rewrites_flagged_planes_only(tile):
    """`boundary.hysteresis` (pass 2 alone) on the CPU: flagged planes get
    the plain version's result (K6's, or K8's bands at `tile`), the others
    keep what `out` held."""
    planes = _planes("voronoi", 40, 72, seed=9)
    out = torch.full(planes.shape, 7.0)
    flags = torch.tensor([1, 0, 1, 0, 0], dtype=torch.int32)
    got = boundary.hysteresis(planes, out, flags, tile=tile)
    assert got is out
    want = boundary.boundary_label_reference(planes)
    assert torch.equal(got[[0, 2]], want[[0, 2]])
    assert bool((got[[1, 3, 4]] == 7.0).all())
    with pytest.raises(ValueError):
        boundary.hysteresis(planes, out, flags[:2], tile=tile)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["noise", "extreme", "small"])
def test_no_int32_plane_has_a_weak_pixel(kind, seed):
    """The parity lemma: Sobel's dx and dy weigh the four corners by +-1
    each and the rest by 0 or +-2, so dx + dy, and with it mag = |dx| +
    |dy|, is even, also as int32 wraps; mag is never the weak 1."""
    if kind == "small":
        rng = np.random.default_rng(seed)
        p = torch.from_numpy(rng.integers(-3, 4, (4, 23, 37), dtype=np.int32))
    else:
        p = _planes(kind, 23, 37, seed)
    dx, dy = boundary._sobel_replicate(p)
    assert not bool(((dx.abs() + dy.abs()) & 1).any())
    assert not bool(boundary._strong_weak(p)[1].any())
