"""Distance labels: exact Euclidean distance transform by jump flooding,
then per-plane min-max to [0, 1] (resuneta_tpu/ops/distance.py:80-115,
multitasking_utils.py:26-35, cv2.distanceTransform(DIST_L2, 0) then
cv2.normalize(NORM_MINMAX)).

K5 is `distance_transform_edt`: on a CUDA tensor it launches the CUDA kernel
(kernels/csrc/jfa.cu) or raises; only a tensor on the CPU takes the plain
version `distance_transform_edt_reference`. Both are bit-identical to the
reference (ops/distance.py and the Pallas kernel ops/pallas/jfa.py): the
same int32 seeds, 1+JFA+1 Jacobi schedule, candidate order and strict <.
`LAUNCHES` counts kernel launches as the CUDA side reports them (one a
pass plus two a call, whatever the number of planes: 13 at 256^2),
`CALLS` wrapper calls on any device.
"""

import ctypes

import torch

from ..kernels import build

LAUNCHES = 0
CALLS = 0

_BIG_I32 = 2 ** 30
# the whole-plane kernel's limit in the reference (jfa.py:31); larger planes
# take the row-tiled kernel K7 there, not ported yet
MAX_PLANE_ELEMS = 768 * 768
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


def shift(arr, di, dj, fill):
    """out[..., i, j] = arr[..., i+di, j+dj], `fill` outside."""
    H, W = arr.shape[-2:]
    out = torch.full_like(arr, fill)
    if abs(di) >= H or abs(dj) >= W:
        return out
    out[..., max(-di, 0):H - max(di, 0), max(-dj, 0):W - max(dj, 0)] = \
        arr[..., max(di, 0):H + min(di, 0), max(dj, 0):W + min(dj, 0)]
    return out


def distance_transform_edt_reference(planes):
    """The plain version: (P, H, W) int32 -> (P, H, W) f32, the distance of
    every nonzero pixel to the nearest zero pixel (2^15 everywhere on a
    plane without one)."""
    P, H, W = planes.shape
    dev = planes.device
    ii = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    jj = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    seed = torch.where(planes != 0, torch.full_like(planes, -1),
                       (ii * W + jj).expand(P, H, W))

    def d2_of(s):
        si = torch.div(s, W, rounding_mode="floor")
        sj = s - si * W
        d2 = (ii - si) ** 2 + (jj - sj) ** 2
        return torch.where(s >= 0, d2, torch.full_like(d2, _BIG_I32))

    # Jacobi: every candidate comes from the pass-start seeds
    for s in jfa_steps(H, W):
        prev = seed
        best = d2_of(prev)
        for di in (-s, 0, s):
            for dj in (-s, 0, s):
                if di == 0 and dj == 0:
                    continue
                ns = shift(prev, di, dj, -1)
                cand = d2_of(ns)
                better = cand < best
                seed = torch.where(better, ns, seed)
                best = torch.where(better, cand, best)
    # correctly rounded, as XLA's and CUDA's sqrtf are: PyTorch's vectorised
    # f32 sqrt on the CPU is not (off by an ulp for ~0.4% of integers below
    # 2^15); the f64 root of an integer rounds to the same f32
    return torch.sqrt(d2_of(seed).double()).float()


def _check(planes):
    if planes.dim() != 3 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be (P, H, W) int32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("jfa").jfa_edt
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def distance_transform_edt(planes):
    """K5: (P, H, W) int32 planes -> (P, H, W) f32 distances (see module
    doc). On the card, planes above 768^2 raise: they need the row-tiled
    kernel K7 (jfa.py:221), which is not ported."""
    global CALLS, LAUNCHES
    _check(planes)
    CALLS += 1
    if planes.device.type == "cpu":
        return distance_transform_edt_reference(planes)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    P, H, W = planes.shape
    if H * W > MAX_PLANE_ELEMS:
        raise ValueError(f"plane {H}x{W} is above the whole-plane limit "
                         f"768^2: it needs the row-tiled JFA kernel K7, "
                         "not ported")
    out = torch.empty((P, H, W), dtype=torch.float32, device=planes.device)
    work = torch.empty((2, P, H, W), dtype=torch.int32, device=planes.device)
    fn = _kernel()
    n = ctypes.c_int(0)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = fn(planes.data_ptr(), out.data_ptr(), work.data_ptr(), P, H, W,
                ctypes.byref(n), stream)
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
    to K5 in one call."""
    H, W, C = label.shape[-3:]
    # zero pixels are the seeds (distance.py:39: binary != 0)
    planes = (label.movedim(-1, -3).reshape(-1, H, W) != 0).to(torch.int32)
    dists = minmax_norm01(distance_transform_edt(planes.contiguous()))
    return dists.reshape(label.shape[:-3] + (C, H, W)).movedim(-3, -1)
