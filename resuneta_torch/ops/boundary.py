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

K6 is `boundary_label`: on a CUDA tensor it launches the CUDA kernel
(kernels/csrc/canny.cu) or raises; only a tensor on the CPU takes the plain
version `boundary_label_reference`. Both are bit-identical to the reference
(ops/boundary.py and the Pallas kernel ops/pallas/canny.py). `LAUNCHES`
counts kernel launches (one a wrapper call on the card, whatever the
number of planes), `CALLS` wrapper calls on any device.
"""

import ctypes

import torch

from ..kernels import build
from .distance import shift

LAUNCHES = 0
CALLS = 0

_TG22 = 13573
HYSTERESIS_ITERS = 32
# the whole-plane kernel's limit in the reference (canny.py:46); larger
# planes take the row-tiled kernel K8 there, not ported yet
MAX_PLANE_ELEMS = 384 * 384
_fn = None


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


def canny_binary(img):
    """Canny(0, 1) of (P, H, W) int32 planes -> bool edges."""
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
    weak = kept & ~strong

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


def cross_dilate(e):
    """3x3 cross dilation (cv2.MORPH_CROSS) of bool planes -> f32 {0, 1}."""
    b = e | shift(e, 0, -1, False) | shift(e, 0, 1, False) | \
        shift(e, -1, 0, False) | shift(e, 1, 0, False)
    return b.float()


def boundary_label_reference(planes):
    """The plain version: (P, H, W) int32 -> (P, H, W) f32 {0, 1}."""
    return cross_dilate(canny_binary(planes))


def _check(planes):
    if planes.dim() != 3 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be (P, H, W) int32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("canny").canny_boundary
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def boundary_label(planes):
    """K6: Canny(0, 1) + cross dilation of (P, H, W) int32 planes ->
    (P, H, W) f32 {0, 1}. On the card, planes above 384^2 raise: they need
    the row-tiled kernel K8 (canny.py:257), which is not ported."""
    global CALLS, LAUNCHES
    _check(planes)
    CALLS += 1
    if planes.device.type == "cpu":
        return boundary_label_reference(planes)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    P, H, W = planes.shape
    if H * W > MAX_PLANE_ELEMS:
        raise ValueError(f"plane {H}x{W} is above the whole-plane limit "
                         f"384^2: it needs the row-tiled Canny kernel K8, "
                         "not ported")
    out = torch.empty((P, H, W), dtype=torch.float32, device=planes.device)
    fn = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = fn(planes.data_ptr(), out.data_ptr(), P, H, W,
                HYSTERESIS_ITERS, stream)
    if rc != 0:
        raise RuntimeError(f"canny kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def get_boundary_label(label):
    """The boundary head's label of a one-hot (..., H, W, C) label: every
    class plane through K6 (all B*C planes of a batch in one call)."""
    H, W, C = label.shape[-3:]
    planes = label.movedim(-1, -3).reshape(-1, H, W).to(torch.int32)
    bounds = boundary_label(planes.contiguous())
    return bounds.reshape(label.shape[:-3] + (C, H, W)).movedim(-3, -1)
