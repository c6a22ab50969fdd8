"""Distance labels: exact Euclidean distance transform by jump flooding,
then per-plane min-max to [0, 1] (resuneta_tpu/ops/distance.py:80-115,
multitasking_utils.py:26-35, cv2.distanceTransform(DIST_L2, 0) then
cv2.normalize(NORM_MINMAX)).

`distance_transform_edt` runs the CUDA kernels of kernels/csrc/jfa.cu,
which replace K5 (ops/pallas/jfa.py:291, whole planes) and K7 (jfa.py:221,
row-tiled), in one of two designs (`plan`):
- "cluster": a thread block cluster holds a whole plane's seeds in shared
  memory and runs every pass of the schedule in one launch (the 256^2
  planes of the 256 px step; 64^2);
- "tail": planes too large for that (512^2, 1024^2) run the leading pass
  and the steps above TAIL as banded passes through device memory, `tile`
  rows a block, and the steps up to TAIL in one cluster launch over bands
  of rows with a shrinking halo.
On a CUDA tensor it launches the kernels or raises; only a tensor on the
CPU takes a plain version, `distance_transform_edt_tiled_reference`, K7's
band decomposition; `distance_transform_edt_reference` is K5's plain
version, the whole-plane flood. All are bit-identical to the reference
(ops/distance.py and the Pallas kernels): the same seeds, 1+JFA+1 Jacobi
schedule, candidate order and strict <. `LAUNCHES` counts the kernel
launches as the CUDA side reports them (one a call in design "cluster":
256^2, 64^2; 1 + the banded passes in design "tail": 8 at 512^2, 9 at
1024^2), `CALLS` wrapper calls on any device.
"""

import ctypes

import torch

from ..device import check_current_device
from ..kernels import build

LAUNCHES = 0
CALLS = 0

_BIG_I32 = 2 ** 30
# a block's shared memory
SMEM_BYTES = 232448
# design "tail"'s banded passes stage three bands of `tile` rows of int32
# seeds and a row of "no seed" (4 * (3 * tile + 1) * W bytes); by default
# the largest power of two up to 16 rows whose bands fit
# DEFAULT_SMEM_BYTES: 8 rows at 256^2, 4 at 512^2, 2 at 1024^2, the
# fastest tile of 1-16 at each on an H100 when every pass ran banded
# (chip_smoke.py phases k5_512, k7: ms_by_tile)
DEFAULT_SMEM_BYTES = 24 * 1024
# design "cluster"'s blocks hold two buffers of R rows of int32 seeds and
# a row of "no seed" (4 * (2 * R + 1) * W bytes): the smallest cluster (a
# power of two up to MAX_CLUSTER) whose blocks' two buffers fit
# CLUSTER_SMEM, three blocks to an SM: 8 blocks of 32 rows at 256^2, the
# faster of 8 and 4 there on an H100 (tools/torch_edt_ablate.py)
CLUSTER_SMEM = 64 * 1024
# the portable cluster size, and the blocks of design "tail"'s clusters
MAX_CLUSTER = 8
# seeds are packed as i << 16 | j, "no seed" a point far off the plane
MAX_SIDE = 8192
# design "tail" fuses the steps up to TAIL (4, 2, 1, 1: a halo of 8 rows),
# or the largest power of two below whose band fits: of 1, 4, 8 and 16 on
# an H100 the fastest at 1024^2 and 1.5% behind 1 at 512^2, where a fused
# pass costs about what a banded one does (tools/torch_edt_ablate.py)
TAIL = 4
DESIGNS = ("cluster", "tail")
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
    """Design "tail"'s band rows: the largest power of two up to 16 whose
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
    if tile < 1 or 4 * (3 * tile + 1) * W > SMEM_BYTES:
        raise ValueError(f"the EDT kernel (K5/K7) takes tile >= 1 with "
                         f"4 * (3 * tile + 1) * W <= {SMEM_BYTES} bytes of "
                         f"shared memory, got tile {tile}, plane {H}x{W}")


def _cdiv(a, b):
    return -(-a // b)


def _whole_plane_cluster(H, W, budget):
    """Design "cluster"'s blocks: the smallest power of two up to
    MAX_CLUSTER whose blocks' two seed buffers fit `budget` bytes (and,
    with a row of "no seed", a block's shared memory); None if none
    does."""
    cs = 1
    while cs <= MAX_CLUSTER:
        R = _cdiv(H, cs)
        if 8 * R * W <= budget and 4 * (2 * R + 1) * W <= SMEM_BYTES:
            return cs
        cs *= 2
    return None


def plan(H, W, design=None, tile=None):
    """The kernels' layout for (H, W) planes: {"design", "steps" (K7's
    filtered schedule), "nbanded" (its leading passes run banded), "tile",
    "cs" (the cluster's blocks), "band" and "halo" (rows of a cluster's band
    and a side of its window), "R" (window rows a block), "launches"}.
    `design` None picks "cluster" where a plane fits CLUSTER_SMEM a block
    and no `tile` is named, else "tail"; `tile` sets the banded passes'
    rows. The cluster's blocks and the fused tail's steps follow the
    module's CLUSTER_SMEM, MAX_CLUSTER and TAIL. Raises ValueError on what
    the kernels cannot take."""
    if not (1 <= H <= MAX_SIDE and 1 <= W <= MAX_SIDE):
        raise ValueError(f"the EDT kernel (K5/K7) takes planes up to "
                         f"{MAX_SIDE}x{MAX_SIDE}, got {H}x{W}")
    if tile is not None:
        _check_tile(H, W, tile)
    if design not in (None,) + DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    steps = tiled_steps(H, W) or [1]     # a 1x1 plane: one empty pass
    if design is None:
        design = ("cluster" if tile is None and
                  _whole_plane_cluster(H, W, CLUSTER_SMEM) else "tail")
    if design == "cluster":
        cs = (_whole_plane_cluster(H, W, CLUSTER_SMEM) or
              _whole_plane_cluster(H, W, SMEM_BYTES))
        if cs is None:
            raise ValueError(f"the EDT kernel (K5/K7) cannot hold a {H}x{W} "
                             f"plane in a cluster of {MAX_CLUSTER} blocks")
        return {"design": design, "steps": steps, "nbanded": 0,
                "tile": None, "cs": cs, "band": H, "halo": 0,
                "R": _cdiv(H, cs), "launches": 1}
    tile = default_tile(W) if tile is None else tile
    cs = MAX_CLUSTER
    rmax = (SMEM_BYTES // (4 * W) - 1) // 2
    for t in [2 ** e for e in range(TAIL.bit_length() - 1, -1, -1)]:
        nb = 1 + sum(s > t for s in steps[1:])
        if nb == len(steps):
            continue
        halo = sum(steps[nb:])
        if cs * rmax >= H:
            band = H
        else:
            band = cs * rmax - 2 * halo
            if band < 1:
                continue
            band = _cdiv(H, _cdiv(H, band))
        return {"design": design, "steps": steps, "nbanded": nb,
                "tile": tile, "cs": cs, "band": band, "halo": halo,
                "R": _cdiv(min(H, band + 2 * halo), cs), "launches": nb + 1}
    raise ValueError(f"the EDT kernel (K5/K7) finds no fused tail for a "
                     f"{H}x{W} plane in clusters of {cs} blocks")


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.load("jfa").jfa_edt
        _fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        _fn.restype = ctypes.c_int
    return _fn


def distance_transform_edt(planes, tile=None, design=None):
    """(P, H, W) int32 planes -> (P, H, W) f32 distances (see module doc),
    in the layout `plan(H, W, design, tile)` gives; on the
    CPU the plain version of K7's bands, of `tile` rows (PLAIN_TILE when
    None)."""
    global CALLS, LAUNCHES
    _check(planes)
    P, H, W = planes.shape
    lay = plan(H, W, design, tile)
    CALLS += 1
    if planes.device.type == "cpu":
        return distance_transform_edt_tiled_reference(
            planes, PLAIN_TILE if tile is None else tile)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    check_current_device(planes)
    if P > 65535:
        raise ValueError(f"the EDT kernel (K5/K7) takes up to 65535 planes "
                         f"a call, got {P}")
    out = torch.empty((P, H, W), dtype=torch.float32, device=planes.device)
    work = (torch.empty((2, P, H, W), dtype=torch.int32,
                        device=planes.device) if lay["nbanded"] else None)
    steps = (ctypes.c_int * len(lay["steps"]))(*lay["steps"])
    n = ctypes.c_int(0)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _kernel()(planes.data_ptr(), out.data_ptr(),
                   None if work is None else work.data_ptr(), P, H, W,
                   steps, len(lay["steps"]), lay["nbanded"],
                   lay["tile"] or 0, lay["cs"], lay["band"], lay["halo"],
                   lay["R"], ctypes.byref(n), stream)
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
