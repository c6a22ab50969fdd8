"""K4: k x k / stride-k max pool followed by a 1x1 convolution, NHWC,
forward and backward.

    y = maxpool_k(x) @ W + bias,   k in {2, 4, 8}

(resuneta_tpu/ops/pallas/poolconv.py pool_conv, :219): PSPPooling's pooled
levels, with no pooled tensor materialised. The pool is taken in f32
(exact), the pooled values and W in the compute type (bf16 for bf16 x, f32
for f32 x), products summed in f32, the bias added in f32, y cast once.

The backward (:139-193, :253-283) is dz = g @ W^T in f32 and

    dx = 1[x == pooled] * dz / ties

cast once, where ties counts the elements of the window equal to its max:
a tie SPLITS the gradient equally (:25-30), which is jnp.max's VJP and not
F.max_pool2d's (that one routes a tie to one element). dW is f32 and
dbias the f32 sum of g. The plain version computes the max, the mask and
the count itself and never uses max_pool2d's backward.

`pool_conv_fwd` and `pool_conv_bwd` are the wrappers: on a CUDA tensor each
launches its kernels (kernels/csrc/poolconv.cu) or raises; only a tensor
on the CPU takes the plain version (`pool_conv_reference`,
`pool_conv_bwd_reference`). `LAUNCHES` and `BWD_LAUNCHES` count kernel
launches as the CUDA side reports them (one a forward call; two a backward
call: the one pass over x and g, and the fixed-order sum of the blocks'
dW / dbias partials), `CALLS` and `BWD_CALLS` wrapper calls on any device.
`pool_conv` is the autograd.Function's entry.
"""

import ctypes

import torch

from ..device import check_current_device
from ..kernels import build
from .convseg import no_tf32, refuse_if_disabled

LAUNCHES = 0
CALLS = 0
BWD_LAUNCHES = 0
BWD_CALLS = 0

# what the kernels are (chip_smoke.py's k4 rows): one pass forward, one
# pass over (x, g) and a fixed-order sum backward
K4_DESIGN = "one_pass"
_fns = None


def _cd(x):
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _windows(x, k):
    """(N, H, W, C) -> (N, H/k, k, W/k, k, C)."""
    N, H, W, C = x.shape
    return x.reshape(N, H // k, k, W // k, k, C)


def max_pool(x, k):
    """k x k / stride-k max pool of an NHWC tensor
    (resuneta_tpu/ops/dense.py:184) whose gradient splits ties equally, as
    jnp.max's does (`amax`'s backward; `F.max_pool2d`'s routes a tie to one
    element)."""
    return x if k == 1 else _windows(x, k).amax(dim=(2, 4))


def pool_conv_reference(x, w, bias, *, k):
    """The plain PyTorch version of K4's forward, with its roundings."""
    pooled = max_pool(x.float(), k)
    with no_tf32():
        y = pooled.to(_cd(x)).float() @ w.to(_cd(x)).float()
    return (y + bias.float()).to(x.dtype)


def pool_conv_bwd_reference(x, g, w, *, k):
    """The plain PyTorch version of K4's backward: (dx, dW (C, cout) f32,
    dbias f32). The window's max, the tie mask and the tie count are
    computed here, not taken from max_pool2d's backward."""
    cd = _cd(x)
    xw = _windows(x.float(), k)
    pooled = xw.amax(dim=(2, 4), keepdim=True)
    mask = (xw == pooled).float()
    ties = mask.sum(dim=(2, 4), keepdim=True)
    gf = g.to(x.dtype).float()
    gg = gf.to(cd).float()
    wc = w.to(cd).float()
    C, cout = w.shape
    with no_tf32():
        dz = gg @ wc.t()                                   # (N, H/k, W/k, C)
        dw = pooled.squeeze(4).squeeze(2).to(cd).float().reshape(-1, C).t() \
            @ gg.reshape(-1, cout)
    dx = mask * (dz[:, :, None, :, None, :] / ties)
    return dx.reshape(x.shape).to(x.dtype), dw, gf.sum((0, 1, 2))


def _check(x, w, bias, k):
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be (N, H, W, C) bf16 or f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    N, H, W, C = x.shape
    if int(k) < 2 or H % k or W % k:
        raise ValueError(f"k={k} must be >= 2 and divide H={H}, W={W}")
    if w.dim() != 2 or w.shape[0] != C or w.shape[1] % 8 or C % 8:
        raise ValueError(f"w must be (C={C}, cout) with C and cout "
                         f"multiples of 8, got {tuple(w.shape)}")
    if bias is not None and bias.shape != (w.shape[1],):
        raise ValueError(f"bias must be ({w.shape[1]},)")
    if w.device != x.device or (bias is not None and
                                bias.device != x.device):
        raise ValueError("w and bias must be on x's device")


def _check_kernel(C, cout, k):
    """What the CUDA kernels take (poolconv.cu): k in {2, 4, 8}, C in {8,
    16, 32}, cout in {8, 16}; the PSP's levels are C = 32, cout = 8."""
    if k not in (2, 4, 8) or C not in (8, 16, 32) or cout not in (8, 16):
        raise ValueError(f"the K4 kernels take k in (2, 4, 8), C in (8, 16, "
                         f"32) and cout in (8, 16); got C={C}, cout={cout}, "
                         f"k={k}")


def _kernels():
    global _fns
    if _fns is None:
        lib = build.load("poolconv")
        fwd = lib.poolconv_forward
        fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.poolconv_backward
        bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        # the backward's blocks write at most this many rows of dW / dbias
        # partials (the kernel chooses its blocks from the shapes)
        lib.poolconv_partial_rows.restype = ctypes.c_int
        _fns = (fwd, bwd, lib.poolconv_partial_rows())
    return _fns


def _aligned(*ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("K4 operands must be 16-byte aligned")


def pool_conv_fwd(x, w, bias, *, k):
    """K4's forward. x: (N, H, W, C) NHWC contiguous, bf16 or f32; w: (C,
    cout) f32; bias: (cout,) f32. Returns (N, H/k, W/k, cout) in x.dtype."""
    global CALLS, LAUNCHES
    _check(x, w, bias, k)
    if x.device.type == "cuda":
        _check_kernel(x.shape[-1], w.shape[1], k)
    CALLS += 1
    if x.device.type == "cpu":
        return pool_conv_reference(x, w, bias, k=k)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_current_device(x)
    N, H, W, C = x.shape
    cout = w.shape[1]
    w32 = w.float().contiguous()       # rounded to the compute type on chip
    b32 = bias.float().contiguous()
    y = torch.empty((N, H // k, W // k, cout), dtype=x.dtype, device=x.device)
    _aligned(x, w32, y)
    n = ctypes.c_int(0)
    fwd, _, _ = _kernels()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fwd(x.data_ptr(), w32.data_ptr(), b32.data_ptr(), y.data_ptr(), N,
             H, W, C, cout, int(k), int(x.dtype == torch.bfloat16),
             ctypes.byref(n), stream)
    LAUNCHES += n.value
    if rc != 0:
        raise RuntimeError(f"poolconv forward launch failed: cudaError {rc}")
    return y


def pool_conv_bwd(x, g, w, *, k):
    """K4's backward. g: (N, H/k, W/k, cout) in x.dtype, contiguous.
    Returns (dx in x's shape and dtype, dW (C, cout) f32, dbias (cout,)
    f32)."""
    global BWD_CALLS, BWD_LAUNCHES
    _check(x, w, None, k)
    N, H, W, C = x.shape
    cout = w.shape[1]
    if tuple(g.shape) != (N, H // k, W // k, cout) or g.dtype != x.dtype \
            or not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"g must be contiguous {(N, H // k, W // k, cout)} "
                         f"{x.dtype}, got {tuple(g.shape)} {g.dtype}")
    if x.device.type == "cuda":
        _check_kernel(C, cout, k)
    BWD_CALLS += 1
    if x.device.type == "cpu":
        return pool_conv_bwd_reference(x, g, w, k=k)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_current_device(x)
    w32 = w.float().contiguous()       # rounded to the compute type on chip
    dx = torch.empty_like(x)
    _, bwd, rows = _kernels()
    # dW with dbias as its last row, and the blocks' partial rows of it
    # (apart, so that the returned gradients do not hold the partials)
    dwb = torch.empty((C + 1, cout), dtype=torch.float32, device=x.device)
    part = torch.empty((rows, C + 1, cout), dtype=torch.float32,
                       device=x.device)
    _aligned(x, g, w32, dx)
    n = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = bwd(x.data_ptr(), g.data_ptr(), w32.data_ptr(), dx.data_ptr(),
             dwb.data_ptr(), part.data_ptr(), N, H, W, C, cout,
             int(k), int(x.dtype == torch.bfloat16), ctypes.byref(n),
             stream)
    BWD_LAUNCHES += n.value
    if rc != 0:
        raise RuntimeError(f"poolconv backward launch failed: cudaError {rc}")
    return dx, dwb[:-1], dwb[-1]


class PoolConv(torch.autograd.Function):
    """K4 forward and backward as one differentiable op of (x, w, bias)."""

    @staticmethod
    def forward(ctx, x, w, bias, k):
        ctx.save_for_backward(x, w)
        ctx.k = k
        return pool_conv_fwd(x, w, bias, k=k)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, dbias = pool_conv_bwd(x, g.to(x.dtype).contiguous(), w,
                                      k=ctx.k)
        return dx, dw, dbias, None


def pool_conv(x, w, bias, *, k):
    """Differentiable K4: x (N, H, W, C) NHWC, w (C, cout) f32, bias
    (cout,) f32 -> (N, H/k, W/k, cout) in x.dtype. Raises inside
    convseg.disabled()."""
    refuse_if_disabled("pool_conv (K4)")
    return PoolConv.apply(x.contiguous(), w, bias, int(k))
