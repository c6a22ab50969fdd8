"""K3: the 1x1 convolution over concat parts, NHWC, forward and backward.

    y = sum_p up_{k_p}(act_p?(x_p)) @ W_p + bias

over P <= 5 parts (resuneta_tpu/ops/pallas/densemm.py dense_mm, :297):
part p is an (N, H/k_p, W/k_p, cin_p) tensor read through a nearest x k_p
upsample (ups), or an (N, H*s, W*s, cin_p) tensor read at every s-th row
and column (strides: the encoder's stride-2 1x1 convolutions, where the
reference instead contracts pixel pairs against [W; 0]), with a ReLU on
its values where act_p. W is one (sum cin_p, cout) matrix, part p's rows
in order. Neither the concat nor an upsampled tensor is materialised.

Roundings (densemm.py:190-262): x_p and W in the compute type (bf16 for
bf16 x, f32 for f32 x), products summed in f32, the bias added in f32, y
cast once. The backward (`_dense_mm_bwd`, :338) gives every dx_p, dW (f32)
and dbias (the f32 sum of g) in one pass over (x, g): an upsampled part
sums its k row replicas of g in f32 and rounds them to the compute type
before the product (:236-244), its k column replicas sum inside the f32
product; dx_p is masked by x_p > 0 where the part has the ReLU; a strided
part's dx is full-resolution and zero at the pixels it does not read.

`dense_mm_fwd` and `dense_mm_bwd` are the wrappers: on a CUDA tensor each
launches its kernels (kernels/csrc/densemm.cu) or raises; only a tensor on
the CPU takes the plain version (`dense_mm_reference`,
`dense_mm_bwd_reference`). bf16 runs the Hopper kernels (TMA, wgmma;
`k3_design` names them "tma_wgmma"), within the limits `refusal` states;
f32 runs PR 3's CUDA-core tiles ("pr3"). `LAUNCHES` and `BWD_LAUNCHES`
count kernel launches as the CUDA side reports them (one a forward call;
`bwd_launches` a backward call: dgrad, wgrad and the fixed-order sum of
wgrad's partials, and in bf16 with an upsampled part first the row sums
of g), `CALLS` and `BWD_CALLS` wrapper calls on any device.
`dense_mm` is the autograd.Function's entry.
"""

import ctypes
import functools

import torch

from ..device import check_current_device
from ..kernels import build
from .convseg import no_tf32, refuse_if_disabled

LAUNCHES = 0
CALLS = 0
BWD_LAUNCHES = 0
BWD_CALLS = 0

MAX_PARTS = 5
# the bf16 kernels' limits (densemm.cu k3::refusal): W^T (forward) and W
# (dgrad) stay in shared memory, 64-channel rows of 128 bytes, N padded
# to 8, 16, ..., 256
_W_BUDGET = 128 * 1024
_ROW = 128
# wgrad blocks to aim for: four waves of the H100's 132 SMs (gemm1x1.cuh's
# tiles: K3 in f32, K4), two (the bf16 kernel's larger blocks)
_WGRAD_BLOCKS = 4 * 132
_BF16_WGRAD_BLOCKS = 2 * 132
_fns = None


def _spec(xs, acts, ups, strides):
    P = len(xs)
    acts = tuple(bool(a) for a in (acts or (False,) * P))
    ups = tuple(int(k) for k in (ups or (1,) * P))
    strides = tuple(int(s) for s in (strides or (1,) * P))
    return acts, ups, strides


def _geometry(xs, ups, strides):
    """(N, H, W) of the output from the parts."""
    N, h, w, _ = xs[0].shape
    if strides[0] > 1:
        return N, h // strides[0], w // strides[0]
    return N, h * ups[0], w * ups[0]


def _cd(x):
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def upsample_nearest(x, k):
    """Nearest x k upsample of an NHWC tensor (resuneta_tpu/ops/dense.py:
    195)."""
    return x if k == 1 else x.repeat_interleave(k, 1).repeat_interleave(k, 2)


def dense_mm_reference(xs, w, bias, *, acts=None, ups=None, strides=None):
    """The plain PyTorch version of K3's forward, with its roundings: each
    part's f32 product (TF32 off; products of bf16 values are exact in
    f32) at the part's own resolution, replicated for an upsampled part,
    summed over parts in f32, plus the f32 bias, cast once."""
    acts, ups, strides = _spec(xs, acts, ups, strides)
    cd = _cd(xs[0])
    acc, off = None, 0
    for x, a, k, s in zip(xs, acts, ups, strides):
        cin = x.shape[3]
        z = torch.relu(x) if a else x
        if s > 1:
            z = z[:, ::s, ::s]
        wp = w[off:off + cin].to(cd).float()
        with no_tf32():
            y = z.float() @ wp
        y = upsample_nearest(y, k)
        acc = y if acc is None else acc + y
        off += cin
    return (acc + bias.float()).to(xs[0].dtype)


def _rowsum(gf, k):
    """The f32 sum of the k row replicas of g, left to right."""
    s = gf[:, 0::k]
    for a in range(1, k):
        s = s + gf[:, a::k]
    return s


def dense_mm_bwd_reference(xs, g, w, *, acts=None, ups=None, strides=None):
    """The plain PyTorch version of K3's backward: (dxs, dW (sum cin, cout)
    f32, dbias f32), with the kernel's roundings (see the module doc)."""
    acts, ups, strides = _spec(xs, acts, ups, strides)
    cd = _cd(xs[0])
    gf = g.to(xs[0].dtype).float()
    dbias = gf.sum((0, 1, 2))
    dxs, dws, off = [], [], 0
    for x, a, k, s in zip(xs, acts, ups, strides):
        cin = x.shape[3]
        wp = w[off:off + cin].to(cd).float()
        z = (torch.relu(x) if a else x).float()
        with no_tf32():
            if k > 1:
                gg = _rowsum(gf, k).to(cd).float()        # (N, H/k, W, cout)
                n, hq, wq, cout = gg.shape
                dx = gg.reshape(n, hq, wq // k, k * cout) @ \
                    wp.t().repeat(k, 1)
                zr = z.repeat_interleave(k, 2)
                dw = zr.reshape(-1, cin).t() @ gg.reshape(-1, cout)
            elif s > 1:
                gg = gf.to(cd).float()
                dx = torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device)
                dx[:, ::s, ::s] = gg @ wp.t()
                zs = z[:, ::s, ::s]
                dw = zs.reshape(-1, cin).t() @ gg.reshape(-1, gg.shape[3])
            else:
                gg = gf.to(cd).float()
                dx = gg @ wp.t()
                dw = z.reshape(-1, cin).t() @ gg.reshape(-1, gg.shape[3])
        if a:
            dx = torch.where(x.float() > 0, dx,
                             torch.zeros((), device=x.device))
        dxs.append(dx.to(x.dtype))
        dws.append(dw)
        off += cin
    return dxs, torch.cat(dws), dbias


def _check(xs, w, bias, acts, ups, strides):
    P = len(xs)
    if not 1 <= P <= MAX_PARTS:
        raise ValueError(f"K3 takes 1 to {MAX_PARTS} parts, got {P}")
    if len(acts) != P or len(ups) != P or len(strides) != P:
        raise ValueError("acts, ups and strides need one entry a part")
    x0 = xs[0]
    if x0.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"parts must be bf16 or f32, got {x0.dtype}")
    N, H, W = _geometry(xs, ups, strides)
    cout = w.shape[1] if w.dim() == 2 else -1
    if cout < 1 or cout % 8 or (bias is not None and bias.shape != (cout,)):
        raise ValueError(f"w must be (sum cin, cout) with cout % 8 == 0 and "
                         f"bias (cout,): {tuple(w.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")
    for x, k, s in zip(xs, ups, strides):
        if x.dim() != 4 or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("every part must be (N, h, w, cin) of one "
                             "dtype and device")
        if not x.is_contiguous():
            raise ValueError("parts must be contiguous NHWC")
        if x.shape[3] % 8:
            raise ValueError(f"cin={x.shape[3]} must be a multiple of 8")
        if k < 1 or s < 1 or (k > 1 and s > 1):
            raise ValueError(f"a part is upsampled or strided: ups {k}, "
                             f"stride {s}")
        want = (N, H * s // k, W * s // k) if s > 1 else (N, H // k, W // k)
        if H % k or W % k or tuple(x.shape[:3]) != want:
            raise ValueError(f"part {tuple(x.shape)} does not fit output "
                             f"{(N, H, W)} at ups {k}, stride {s}")
    if w.shape[0] != sum(x.shape[3] for x in xs):
        raise ValueError(f"w has {w.shape[0]} rows, parts "
                         f"{sum(x.shape[3] for x in xs)} channels")
    if w.device != x0.device or (bias is not None and
                                 bias.device != x0.device):
        raise ValueError("w and bias must be on the parts' device")
    if x0.device.type == "cuda" and x0.dtype == torch.bfloat16:
        why = _refusal(tuple(x.shape[3] for x in xs), cout, tuple(ups))
        if why:
            raise ValueError(f"K3's bf16 kernels refuse this call: {why}")


def _kernels():
    global _fns
    if _fns is None:
        lib = build.load("densemm")
        arr = [ctypes.c_void_p] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
        fwd = lib.densemm_forward
        fwd.argtypes = arr + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.densemm_backward
        bwd.argtypes = arr + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


def _carrays(xs, acts, ups, strides):
    P = len(xs)
    ptrs = (ctypes.c_void_p * P)(*(x.data_ptr() for x in xs))
    ints = [(ctypes.c_int * P)(*v) for v in
            ([x.shape[3] for x in xs], ups, strides, [int(a) for a in acts])]
    return ptrs, ints


def _aligned(*ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("K3 operands must be 16-byte aligned")


def _pad_n(n):
    p = 8
    while p < n:
        p *= 2
    return p


def _dgrad_groups(cins, ups):
    """dgrad's column groups (densemm.cu k3::backward): the parts at the
    output's resolution or strided while their channels fit 256 columns,
    then each upsampled part alone: [(k, width)]."""
    groups = []
    for k in (1, 2, 4, 8):
        for c in (c for c, kk in zip(cins, ups) if kk == k):
            if groups and k == 1 and groups[-1][1] + c <= 256:
                groups[-1] = (1, groups[-1][1] + c)
            else:
                groups.append((k, c))
    return groups


@functools.lru_cache(maxsize=256)
def _refusal(cins, cout, ups):
    return refusal(cins, cout, ups)


def refusal(cins, cout, ups):
    """Why the bf16 kernels refuse these shapes, or None: one wgmma N
    (cin, cout <= 256), ups 1, 2, 4 or 8, at least one part at the
    output's resolution or strided (dbias rides on its wgrad blocks), and
    W^T (forward) and W (dgrad) within _W_BUDGET of shared memory."""
    if cout > 256 or max(cins) > 256:
        return f"cin {max(cins)} or cout {cout} over 256"
    if any(k not in (1, 2, 4, 8) for k in ups):
        return f"ups {ups} not all 1, 2, 4 or 8"
    if all(k > 1 for k in ups):
        return "every part is upsampled"
    slices = sum(-(-c // 64) for c in cins)
    if slices * _pad_n(cout) * _ROW > _W_BUDGET:
        return f"W^T ({slices} x {_pad_n(cout)} rows) over the shared memory"
    widths = [w for _, w in _dgrad_groups(cins, ups)]
    if len(widths) * -(-cout // 64) * _pad_n(max(widths)) * _ROW > _W_BUDGET:
        return "W over dgrad's shared memory"
    return None


def bwd_launches(dtype, ups):
    """Kernel launches of one CUDA backward call: dgrad, wgrad and the
    fixed-order sum of its partials; in bf16 with an upsampled part also
    k3_rowsum_kernel (gg_k = bf16 of the f32 sum of k rows of g) first."""
    return 3 + int(dtype == torch.bfloat16 and any(k > 1 for k in ups))


def k3_design(dtype):
    """The kernels a CUDA call of this dtype runs: "tma_wgmma" (bf16) or
    "pr3" (f32, PR 3's CUDA-core tiles)."""
    return "tma_wgmma" if dtype == torch.bfloat16 else "pr3"


def wgrad_chunks(cins, cout, pixels):
    """Pixel chunks of gemm1x1.cuh's weight gradient (K3 in f32):
    about _WGRAD_BLOCKS blocks over the (32-channel, 64-output) tiles of
    every part and the bias row, and at most one chunk per 64 pixels."""
    otiles = -(-cout // 64) if cout > 32 else 1
    tiles = (sum(-(-c // 32) for c in cins) + 1) * otiles
    return max(1, min(-(-_WGRAD_BLOCKS // tiles), -(-pixels // 64)))


def bf16_wgrad_chunks(cins, ups, pixels):
    """Pixel chunks of the bf16 wgrad's units at the output's resolution:
    about two waves of the H100's 132 SMs over all its blocks (a unit is
    two 64-channel slices of one k's parts and takes ceil(chunks / k)
    blocks), at most one chunk per 64 pixels."""
    return _bf16_wgrad_chunks(tuple(cins), tuple(ups), pixels)


@functools.lru_cache(maxsize=256)
def _bf16_wgrad_chunks(cins, ups, pixels):
    weight = 0.0
    for k in set(ups):
        n = sum(-(-c // 64) for c, kk in zip(cins, ups) if kk == k)
        weight += -(-n // 2) / k
    return max(1, min(int(_BF16_WGRAD_BLOCKS / weight), -(-pixels // 64)))


def dense_mm_fwd(xs, w, bias, *, acts=None, ups=None, strides=None):
    """K3's forward (see module doc). xs: parts, NHWC contiguous, bf16 or
    f32; w: (sum cin, cout) f32; bias: (cout,) f32. Returns (N, H, W, cout)
    in the parts' dtype."""
    global CALLS, LAUNCHES
    acts, ups, strides = _spec(xs, acts, ups, strides)
    _check(xs, w, bias, acts, ups, strides)
    CALLS += 1
    x0 = xs[0]
    if x0.device.type == "cpu":
        return dense_mm_reference(xs, w, bias, acts=acts, ups=ups,
                                  strides=strides)
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    check_current_device(x0)
    N, H, W = _geometry(xs, ups, strides)
    cout = w.shape[1]
    bf16 = x0.dtype == torch.bfloat16
    # W^T (bf16: the kernel keeps it K-major) or W (f32), in the compute type
    wc = (w.t() if bf16 else w).to(
        _cd(x0), memory_format=torch.contiguous_format).contiguous()
    b32 = bias.float().contiguous()
    y = torch.empty((N, H, W, cout), dtype=x0.dtype, device=x0.device)
    _aligned(*xs, wc, y)
    ptrs, (cins, up, st, ac) = _carrays(xs, acts, ups, strides)
    n = ctypes.c_int(0)
    fwd, _ = _kernels()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    rc = fwd(ctypes.cast(ptrs, ctypes.c_void_p), cins, up, st, ac,
             len(xs), wc.data_ptr(), b32.data_ptr(), y.data_ptr(), N, H,
             W, cout, int(x0.dtype == torch.bfloat16), ctypes.byref(n),
             stream)
    LAUNCHES += n.value
    if rc != 0:
        raise RuntimeError(f"densemm forward launch failed: cudaError {rc}")
    return y


def dense_mm_bwd(xs, g, w, *, acts=None, ups=None, strides=None):
    """K3's backward. g: (N, H, W, cout) in the parts' dtype, contiguous.
    Returns (dxs in the parts' shapes and dtype, dW (sum cin, cout) f32,
    dbias (cout,) f32)."""
    global BWD_CALLS, BWD_LAUNCHES
    acts, ups, strides = _spec(xs, acts, ups, strides)
    cout = w.shape[1]
    _check(xs, w, None, acts, ups, strides)
    x0 = xs[0]
    N, H, W = _geometry(xs, ups, strides)
    if tuple(g.shape) != (N, H, W, cout) or g.dtype != x0.dtype or \
            not g.is_contiguous() or g.device != x0.device:
        raise ValueError(f"g must be contiguous {(N, H, W, cout)} "
                         f"{x0.dtype}, got {tuple(g.shape)} {g.dtype}")
    BWD_CALLS += 1
    if x0.device.type == "cpu":
        return dense_mm_bwd_reference(xs, g, w, acts=acts, ups=ups,
                                      strides=strides)
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    check_current_device(x0)
    bf16 = x0.dtype == torch.bfloat16
    # W (bf16: dgrad reads its rows) or W^T (f32), in the compute type
    wk = (w if bf16 else w.t()).to(
        _cd(x0), memory_format=torch.contiguous_format).contiguous()
    dxs = [torch.empty_like(x) for x in xs]
    cins = [x.shape[3] for x in xs]
    dwb = torch.empty((sum(cins) + 1, cout), dtype=torch.float32,
                      device=x0.device)
    chunks = _bf16_wgrad_chunks(tuple(cins), tuple(ups), N * H * W) if bf16 \
        else wgrad_chunks(cins, cout, N * H * W)
    # the per-chunk partials of [dW; dbias], then (bf16, upsampled parts)
    # gg_k = bf16(the f32 sum of k rows of g) for each k: (N, H/k, W, cout)
    gg = sum(N * (H // k) * W * cout for k in set(ups) if k > 1) \
        if bf16 else 0
    work = torch.empty(chunks * (sum(cins) + 1) * cout + gg // 2,
                       dtype=torch.float32, device=x0.device)
    _aligned(*xs, g, wk, *dxs)
    ptrs, (ci, up, st, ac) = _carrays(xs, acts, ups, strides)
    dptrs = (ctypes.c_void_p * len(xs))(*(d.data_ptr() for d in dxs))
    n = ctypes.c_int(0)
    _, bwd = _kernels()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    rc = bwd(ctypes.cast(ptrs, ctypes.c_void_p), ci, up, st, ac, len(xs),
             g.data_ptr(), wk.data_ptr(),
             ctypes.cast(dptrs, ctypes.c_void_p), dwb.data_ptr(),
             work.data_ptr(), chunks, N, H, W, cout,
             int(x0.dtype == torch.bfloat16), ctypes.byref(n), stream)
    BWD_LAUNCHES += n.value
    if rc != 0:
        raise RuntimeError(f"densemm backward launch failed: cudaError {rc}")
    return dxs, dwb[:-1], dwb[-1]


class DenseMM(torch.autograd.Function):
    """K3 forward and backward as one differentiable op of (w, bias, *xs)."""

    @staticmethod
    def forward(ctx, w, bias, spec, *xs):
        ctx.save_for_backward(w, *xs)
        ctx.spec = spec
        return dense_mm_fwd(xs, w, bias, **spec)

    @staticmethod
    def backward(ctx, g):
        w, *xs = ctx.saved_tensors
        dxs, dw, dbias = dense_mm_bwd(xs, g.to(xs[0].dtype).contiguous(), w,
                                      **ctx.spec)
        return (dw, dbias, None, *dxs)


def dense_mm(xs, w, bias, *, acts=None, ups=None, strides=None):
    """Differentiable K3: xs NHWC parts, w (sum cin, cout) f32, bias (cout,)
    f32 -> (N, H, W, cout) in the parts' dtype. Raises inside
    convseg.disabled()."""
    refuse_if_disabled("dense_mm (K3)")
    acts, ups, strides = _spec(xs, acts, ups, strides)
    spec = {"acts": acts, "ups": ups, "strides": strides}
    return DenseMM.apply(w, bias, spec, *[x.contiguous() for x in xs])
