"""Distance labels: exact Euclidean distance transform by jump flooding,
then per-plane min-max to [0, 1] (resuneta_tpu/ops/distance.py:80-115,
multitasking_utils.py:26-35, cv2.distanceTransform(DIST_L2, 0) then
cv2.normalize(NORM_MINMAX)).

`distance_transform_edt` runs one CUDA kernel (kernels/csrc/jfa.cu) for
every plane: one launch a pass over bands of rows staged in shared memory,
the design of K7, the reference's row-tiled flood (ops/pallas/jfa.py:221),
which on an H100 also beats a whole-plane flood like K5 (jfa.py:291) on the
planes of 256^2 and 512^2 the reference gives K5. On a CUDA tensor it
launches the kernel or raises; only a tensor on the CPU takes a plain
version, `distance_transform_edt_tiled_reference`, the same band
decomposition; `distance_transform_edt_reference` is K5's plain version,
the whole-plane flood. All are bit-identical to the reference
(ops/distance.py and the Pallas kernels): the same int32 seeds, 1+JFA+1
Jacobi schedule, candidate order and strict <. `LAUNCHES` counts the
kernel launches as the CUDA side reports them (one a pass plus two a call,
whatever the number of planes: 12 at 256^2, 13 at 512^2, 14 at 1024^2),
`CALLS` wrapper calls on any device.
"""

import ctypes

import torch

from ..kernels import build

LAUNCHES = 0
CALLS = 0

_BIG_I32 = 2 ** 30
# the kernel stages three bands of `tile` rows of int32 seeds in a block's
# shared memory, at most SMEM_BYTES; by default it takes the largest power
# of two up to 16 rows whose bands fit DEFAULT_SMEM_BYTES: 8 rows at 256^2,
# 4 at 512^2, 2 at 1024^2, the fastest tile of 1-16 at each on an H100
# (chip_smoke.py phases k5, k5_512, k7: ms_by_tile)
SMEM_BYTES = 232448
DEFAULT_SMEM_BYTES = 24 * 1024
# the band rows of the plain version when the caller names none: the
# reference's row tile at 1024^2 (jfa.py _pick_tile); the result does not
# depend on the tile, and few bands keep the CPU quick
PLAIN_TILE = 256
_fn = None


def jfa_steps(H, W):
    """1+JFA+1: a leading step-1 pass, the halving steps from the power of
    two >= max(H, W), and a trailing step-1 pass (jfa.py:57-70)."""
    step = 1
    while step < max(H, W):
        step <<= 1
    steps = [1]
    while step >= 1:
        steps.append(step)
        step >>= 1
    return steps + [1]


def tiled_steps(H, W):
    """The kernel's schedule, K7's: jfa_steps without the steps s >= H and
    >= W, which find every candidate outside the plane (jfa.py:214)."""
    return [s for s in jfa_steps(H, W) if s < max(H, W)]


def shift(arr, di, dj, fill):
    """out[..., i, j] = arr[..., i+di, j+dj], `fill` outside."""
    H, W = arr.shape[-2:]
    out = torch.full_like(arr, fill)
    if abs(di) >= H or abs(dj) >= W:
        return out
    out[..., max(-di, 0):H - max(di, 0), max(-dj, 0):W - max(dj, 0)] = \
        arr[..., max(di, 0):H + min(di, 0), max(dj, 0):W + min(dj, 0)]
    return out


def _coords(H, W, device):
    return (torch.arange(H, dtype=torch.int32, device=device)[:, None],
            torch.arange(W, dtype=torch.int32, device=device)[None, :])


def _seeds(planes):
    """p = i*W + j at zero pixels, -1 elsewhere."""
    H, W = planes.shape[-2:]
    ii, jj = _coords(H, W, planes.device)
    return torch.where(planes != 0, torch.full_like(planes, -1),
                       (ii * W + jj).expand(planes.shape))


def _d2(s, ii, jj, W):
    """Squared distance from pixel (ii, jj) to seed s; 2^30 for no seed."""
    si = torch.div(s, W, rounding_mode="floor")
    sj = s - si * W
    d2 = (ii - si) ** 2 + (jj - sj) ** 2
    return torch.where(s >= 0, d2, torch.full_like(d2, _BIG_I32))


def _take_better(ns, ii, jj, W, seed, best):
    cand = _d2(ns, ii, jj, W)
    better = cand < best
    return torch.where(better, ns, seed), torch.where(better, cand, best)


def _distances(seed):
    # correctly rounded, as XLA's and CUDA's sqrtf are: PyTorch's vectorised
    # f32 sqrt on the CPU is not (off by an ulp for ~0.4% of integers below
    # 2^15); the f64 root of an integer rounds to the same f32
    H, W = seed.shape[-2:]
    ii, jj = _coords(H, W, seed.device)
    return torch.sqrt(_d2(seed, ii, jj, W).double()).float()


def distance_transform_edt_reference(planes):
    """K5's plain version: (P, H, W) int32 -> (P, H, W) f32, the distance
    of every nonzero pixel to the nearest zero pixel (2^15 everywhere on a
    plane without one)."""
    H, W = planes.shape[-2:]
    ii, jj = _coords(H, W, planes.device)
    seed = _seeds(planes)
    # Jacobi: every candidate comes from the pass-start seeds
    for s in jfa_steps(H, W):
        prev = seed
        best = _d2(prev, ii, jj, W)
        for di in (-s, 0, s):
            for dj in (-s, 0, s):
                if di or dj:
                    seed, best = _take_better(shift(prev, di, dj, -1), ii, jj,
                                              W, seed, best)
    return _distances(seed)


def distance_transform_edt_tiled_reference(planes, tile):
    """The kernel's plain version, K7's band decomposition (jfa.py
    _tiled_impl): per pass of the filtered schedule, each band of `tile`
    rows takes its 9 candidates from the row bands {-s, 0, +s} of the
    pass-start seeds, over a plane padded with -1 by the largest step
    below H (row offsets (0,) when s >= H, column offsets when s >= W).
    Bit-identical to the whole-plane version at any tile."""
    P, H, W = planes.shape
    ii, jj = _coords(H, W, planes.device)
    seed = _seeds(planes)
    steps = tiled_steps(H, W)
    halo = max([s for s in steps if s < H], default=0)
    pad = torch.full((P, halo, W), -1, dtype=seed.dtype, device=seed.device)
    for s in steps:
        padded = torch.cat([pad, seed, pad], dim=1)
        dis = (-s, 0, s) if s < H else (0,)
        djs = (-s, 0, s) if s < W else (0,)
        nxt = torch.empty_like(seed)
        for r0 in range(0, H, tile):
            r1 = min(r0 + tile, H)
            bi = ii[r0:r1]
            bands = {di: padded[:, halo + r0 + di:halo + r1 + di]
                     for di in dis}
            best_seed = bands[0]
            best = _d2(best_seed, bi, jj, W)
            for di in dis:
                for dj in djs:
                    if di or dj:
                        best_seed, best = _take_better(
                            shift(bands[di], 0, dj, -1), bi, jj, W,
                            best_seed, best)
            nxt[:, r0:r1] = best_seed
        seed = nxt
    return _distances(seed)


def default_tile(W):
    """The kernel's band rows: the largest power of two up to 16 whose
    three bands of int32 seeds fit DEFAULT_SMEM_BYTES (2 at W = 1024), at
    least 1."""
    tile = 16
    while tile > 1 and 12 * tile * W > DEFAULT_SMEM_BYTES:
        tile //= 2
    return tile


def _check(planes):
    if planes.dim() != 3 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be (P, H, W) int32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")


def _check_tile(H, W, tile):
    if tile < 1 or 12 * tile * W > SMEM_BYTES or H >= 2 ** 15:
        raise ValueError(f"the EDT kernel (K5/K7) takes tile >= 1 with "
                         f"12 * tile * W <= {SMEM_BYTES} bytes of shared "
                         f"memory and H < 32768 (seeds packed as i << 16 | "
                         f"j), got tile {tile}, plane {H}x{W}")


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.load("jfa").jfa_edt
        _fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        _fn.restype = ctypes.c_int
    return _fn


def distance_transform_edt(planes, tile=None):
    """(P, H, W) int32 planes -> (P, H, W) f32 distances (see module doc),
    in bands of `tile` rows: by default `default_tile(W)` on the card,
    PLAIN_TILE on the CPU."""
    global CALLS, LAUNCHES
    _check(planes)
    P, H, W = planes.shape
    _check_tile(H, W, default_tile(W) if tile is None else tile)
    CALLS += 1
    if planes.device.type == "cpu":
        return distance_transform_edt_tiled_reference(
            planes, PLAIN_TILE if tile is None else tile)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    if tile is None:
        tile = default_tile(W)
    out = torch.empty((P, H, W), dtype=torch.float32, device=planes.device)
    work = torch.empty((2, P, H, W), dtype=torch.int32, device=planes.device)
    n = ctypes.c_int(0)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = _kernel()(planes.data_ptr(), out.data_ptr(), work.data_ptr(), P,
                       H, W, tile, ctypes.byref(n), stream)
    LAUNCHES += n.value
    if rc != 0:
        raise RuntimeError(f"jfa kernel launch failed: cudaError {rc}")
    return out


def minmax_norm01(d):
    """Per plane (last two axes) to [0, 1]; an all-equal plane gives 0."""
    mn = d.amin(dim=(-2, -1), keepdim=True)
    mx = d.amax(dim=(-2, -1), keepdim=True)
    rng = mx - mn
    ok = rng > 0
    return torch.where(ok, (d - mn) / torch.where(ok, rng, torch.ones_like(rng)),
                       torch.zeros_like(d))


def get_distance_label(label):
    """The distance head's label of a one-hot (..., H, W, C) label: the EDT
    of every class plane, min-max normalised; all B*C planes of a batch go
    to the kernel in one call."""
    H, W, C = label.shape[-3:]
    # zero pixels are the seeds (distance.py:39: binary != 0)
    planes = (label.movedim(-1, -3).reshape(-1, H, W) != 0).to(torch.int32)
    dists = minmax_norm01(distance_transform_edt(planes.contiguous()))
    return dists.reshape(label.shape[:-3] + (C, H, W)).movedim(-3, -1)
