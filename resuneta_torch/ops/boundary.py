"""Boundary labels: OpenCV's Canny(channel, 0, 1) on every class plane, then
a 3x3 cross dilation (resuneta_tpu/ops/boundary.py:48-147,
multitasking_utils.py:6-23).

Canny as OpenCV computes it (modules/imgproc/src/canny.cpp): Sobel aperture
3 with BORDER_REPLICATE, L1 magnitude, non-maximum suppression with the
fixed-point tan(22.5°) = 13573 / 2^15 and OpenCV's tie-breaking, magnitudes
zero outside the plane, then hysteresis (low 0, high 1) as at most 32
Jacobi rounds of weak pixels joining 8-connected edges, stopping early once
a round changes nothing. On integer planes no round runs: Sobel's dx and dy
see the same four corners with weight 1 (the rest with weight 2 or 0), so
|dx| + |dy| is even and never the weak magnitude 1.

`boundary_label` routes as the reference does (ops/pallas/canny.py:224):
planes up to 384^2 take K6, the whole-plane kernel (canny.py:227), larger
ones K8, the row-tiled kernel (canny.py:257), which computes each band of
rows from a halo of HYSTERESIS_ITERS + 3 rows on each side; `tile=` forces
K8 on any plane. On a CUDA tensor each launches its CUDA kernels
(kernels/csrc/canny.cu) or raises; only a tensor on the CPU takes the
plain versions, `boundary_label_reference` and
`boundary_label_tiled_reference`. All are bit-identical to the reference
(ops/boundary.py and the Pallas kernel).

On the card a call is two launches, PASSES (after clearing a flag a plane):
pass 1, the same for K6 and K8, a stencil kernel over tiles of TILE_ROWS x
TILE_COLS pixels that computes Sobel, NMS and the thresholds once a pixel,
writes the cross dilation of the strong pixels and flags a plane with a
weak pixel; pass 2, the band kernel (the whole plane for K6, bands of
`tile` rows for K8) with the hysteresis rounds, which computes only the
flagged planes again (`hysteresis` launches it alone). `LAUNCHES` counts
K6's kernel launches and `TILED_LAUNCHES` K8's (PASSES a wrapper call on
the card, whatever the number of planes), `CALLS` wrapper calls on any
device.
"""

import ctypes

import torch

from ..device import check_current_device
from ..kernels import build
from .distance import shift

LAUNCHES = 0
TILED_LAUNCHES = 0
CALLS = 0
# launches a call on the card: pass 1 and pass 2
PASSES = 2
# pass 1's tile of output pixels (canny.cu TH, TW); it reads 3 pixels
# around it: 1 for Sobel, 1 for NMS, 1 for the cross dilation
TILE_ROWS, TILE_COLS = 32, 64

_TG22 = 13573
HYSTERESIS_ITERS = 32
# K8's halo: 1 row Sobel + 2 rows NMS + a row a hysteresis round + 1 row
# dilation (canny.py:57-59)
HALO = HYSTERESIS_ITERS + 3
# the whole-plane kernel's limit in the reference (canny.py:46); larger
# planes take the row-tiled kernel K8, there and here
MAX_PLANE_ELEMS = 384 * 384
# K8 keeps a byte a pixel of its band and halo rows in a block's shared
# memory, at most SMEM_BYTES; its band is DEFAULT_TILE rows where that fits
SMEM_BYTES = 232448
DEFAULT_TILE = 128
_fns = {}


def _sobel_replicate(img):
    """Sobel dx, dy (aperture 3) of (P, H, W) int32 planes, replicate
    border, exact int32."""
    H, W = img.shape[-2:]
    rows = torch.arange(-1, H + 1, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=img.device).clamp(0, W - 1)
    p = img[:, rows][:, :, cols]                                 # (P, H+2, W+2)
    sm_rows = p[:, :-2, :] + 2 * p[:, 1:-1, :] + p[:, 2:, :]     # (P, H, W+2)
    dx = sm_rows[:, :, 2:] - sm_rows[:, :, :-2]
    sm_cols = p[:, :, :-2] + 2 * p[:, :, 1:-1] + p[:, :, 2:]     # (P, H+2, W)
    dy = sm_cols[:, 2:, :] - sm_cols[:, :-2, :]
    return dx, dy


def _dilate8(b):
    out = b
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                out = out | shift(b, di, dj, False)
    return out


def _strong_weak(img):
    """Sobel, NMS and the thresholds of (P, H, W) int32 planes -> the
    strong and weak edge pixels (bool)."""
    dx, dy = _sobel_replicate(img)
    mag = dx.abs() + dy.abs()

    def m(di, dj):
        return shift(mag, di, dj, 0)

    x_abs = dx.abs()
    y_sh = dy.abs() << 15
    tg22x = x_abs * _TG22
    tg67x = tg22x + ((x_abs + x_abs) << 15)
    horiz = y_sh < tg22x
    vert = y_sh > tg67x
    s_neg = (dx ^ dy) < 0
    keep_h = (mag > m(0, -1)) & (mag >= m(0, 1))
    keep_v = (mag > m(-1, 0)) & (mag >= m(1, 0))
    keep_d_pos = (mag > m(-1, -1)) & (mag > m(1, 1))
    keep_d_neg = (mag > m(-1, 1)) & (mag > m(1, -1))
    keep_diag = torch.where(s_neg, keep_d_neg, keep_d_pos)
    kept = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_diag))
    kept = kept & (mag > 0)
    strong = kept & (mag > 1)
    return strong, kept & ~strong


def _hysteresis(strong, weak):
    # Jacobi rounds from the round-start edges, capped; planes that stop
    # changing are fixed points, so one loop over the batch is the same as
    # one loop per plane
    edges = strong
    changed = bool(weak.any())
    i = 0
    while i < HYSTERESIS_ITERS and changed:
        grown = edges | (weak & _dilate8(edges))
        changed = bool((grown != edges).any())
        edges = grown
        i += 1
    return edges


def canny_binary(img):
    """Canny(0, 1) of (P, H, W) int32 planes -> bool edges."""
    return _hysteresis(*_strong_weak(img))


def cross_dilate(e):
    """3x3 cross dilation (cv2.MORPH_CROSS) of bool planes -> f32 {0, 1}."""
    b = e | shift(e, 0, -1, False) | shift(e, 0, 1, False) | \
        shift(e, -1, 0, False) | shift(e, 1, 0, False)
    return b.float()


def boundary_label_reference(planes):
    """K6's plain version: (P, H, W) int32 -> (P, H, W) f32 {0, 1}."""
    return cross_dilate(canny_binary(planes))


def boundary_label_tiled_reference(planes, tile):
    """K8's plain version, the same band decomposition as the kernel: each
    band of `tile` rows from a window of HALO more rows on each side inside
    the plane. Sobel and NMS see two rows of context past the window, so
    their borders are the plane's, exact on every window row; the
    hysteresis (stopping early per band, as the reference's) and the
    dilation see the window's edge, which reaches at most 33 rows in and
    never a band row. Bit-identical to the whole-plane version."""
    P, H, W = planes.shape
    out = torch.empty((P, H, W), dtype=torch.float32, device=planes.device)
    for r0 in range(0, H, tile):
        r1 = min(r0 + tile, H)
        w0, w1 = max(r0 - HALO, 0), min(r1 + HALO, H)
        c0, c1 = max(w0 - 2, 0), min(w1 + 2, H)
        strong, weak = _strong_weak(planes[:, c0:c1])
        edges = _hysteresis(strong[:, w0 - c0:w1 - c0],
                            weak[:, w0 - c0:w1 - c0])
        out[:, r0:r1] = cross_dilate(edges)[:, r0 - w0:r1 - w0]
    return out


def default_tile(H, W):
    """K8's band rows: DEFAULT_TILE, halved until the window of
    min(H, tile + 2 * HALO) rows of W bytes fits SMEM_BYTES; 0 if none
    does (W above 3,273)."""
    tile = DEFAULT_TILE
    while tile and min(H, tile + 2 * HALO) * W > SMEM_BYTES:
        tile //= 2
    return tile


def _check(planes):
    if planes.dim() != 3 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be (P, H, W) int32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")


def _check_tile(H, W, tile):
    if tile < 1 or min(H, tile + 2 * HALO) * W > SMEM_BYTES:
        raise ValueError(f"K8 takes tile >= 1 with min(H, tile + "
                         f"{2 * HALO}) * W <= {SMEM_BYTES} bytes of shared "
                         f"memory, got tile {tile}, plane {H}x{W}")


def _kernel(name):
    if name not in _fns:
        fn = getattr(build.load("canny"), name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (
            4 if name == "canny_boundary" else 6) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _launched(rc, tiled, n):
    global LAUNCHES, TILED_LAUNCHES
    if rc != 0:
        raise RuntimeError(f"canny kernel launch failed: cudaError {rc}")
    if tiled:
        TILED_LAUNCHES += n
    else:
        LAUNCHES += n


def boundary_label(planes, tile=None):
    """Canny(0, 1) + cross dilation of (P, H, W) int32 planes -> (P, H, W)
    f32 {0, 1}: K6 for planes up to 384^2, K8 in bands of `tile` rows
    (default_tile) above that or when `tile` is given."""
    global CALLS
    _check(planes)
    P, H, W = planes.shape
    tiled = tile is not None or H * W > MAX_PLANE_ELEMS
    if tiled:
        tile = default_tile(H, W) if tile is None else tile
        _check_tile(H, W, tile)
    CALLS += 1
    if planes.device.type == "cpu":
        if tiled:
            return boundary_label_tiled_reference(planes, tile)
        return boundary_label_reference(planes)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    check_current_device(planes)
    out = torch.empty((P, H, W), dtype=torch.float32, device=planes.device)
    flags = torch.empty(P, dtype=torch.int32, device=planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    args = (planes.data_ptr(), out.data_ptr(), flags.data_ptr(), P, H, W)
    if tiled:
        rc = _kernel("canny_boundary_tiled")(*args, tile, HALO,
                                             HYSTERESIS_ITERS, stream)
    else:
        rc = _kernel("canny_boundary")(*args, HYSTERESIS_ITERS, stream)
    _launched(rc, tiled, PASSES)
    return out


def hysteresis(planes, out, flags, tile=None):
    """Pass 2 alone: every plane p of `planes` with flags[p] != 0 is
    computed again, hysteresis rounds and all, into out[p] (K6's whole
    plane, or K8's bands of `tile` rows with tile given); the other planes
    of `out` are left as they are. On integer planes the flags pass 1 sets
    are never set, so this runs the path only when a caller asks. On the
    CPU the flagged planes take the plain versions. Returns out."""
    _check(planes)
    P, H, W = planes.shape
    if out.shape != planes.shape or out.dtype != torch.float32 or \
            not out.is_contiguous():
        raise ValueError("out must be (P, H, W) f32, contiguous")
    if flags.shape != (P,) or flags.dtype != torch.int32:
        raise ValueError("flags must be (P,) int32")
    if any(t.device != planes.device for t in (out, flags)):
        raise ValueError("planes, out and flags must be on one device")
    tiled = tile is not None
    if tiled:
        _check_tile(H, W, tile)
    elif H * W > SMEM_BYTES:
        raise ValueError(f"K6's pass 2 keeps a byte a pixel in shared "
                         f"memory: H * W <= {SMEM_BYTES}, got {H}x{W}")
    if planes.device.type == "cpu":
        sel = flags != 0
        if bool(sel.any()):
            out[sel] = boundary_label_tiled_reference(planes[sel], tile) \
                if tiled else boundary_label_reference(planes[sel])
        return out
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    check_current_device(planes)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _kernel("canny_hysteresis")(
        planes.data_ptr(), out.data_ptr(), flags.data_ptr(), P, H, W,
        tile if tiled else H, HALO if tiled else 0, HYSTERESIS_ITERS,
        stream)
    _launched(rc, tiled, 1)
    return out


def get_boundary_label(label):
    """The boundary head's label of a one-hot (..., H, W, C) label: every
    class plane through K6 or K8 (all B*C planes of a batch in one call)."""
    H, W, C = label.shape[-3:]
    planes = label.movedim(-1, -3).reshape(-1, H, W).to(torch.int32)
    bounds = boundary_label(planes.contiguous())
    return bounds.reshape(label.shape[:-3] + (C, H, W)).movedim(-3, -1)
