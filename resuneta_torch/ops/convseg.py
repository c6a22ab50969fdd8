"""The fused ResBlock branch segment BN -> ReLU -> dilated 3x3 conv, NHWC:
K1 (forward), K2 (backward) and its wide tier K9 (C = 256).

K1:  y = conv_{3x3, dilation d, SAME zero pad}(z) + bias,  z = act(x * a + b)

z is x*a + b rounded once to f32 (a fused multiply-add, as XLA forms it),
is zero outside the image (the conv's padding of z, not act(b)) and is
rounded to bf16 once; the taps are bf16(w); products are summed in f32; the
bias is added in f32 and y is cast to x's dtype. This is the function of
resuneta_tpu/ops/pallas/convseg.py bn_act_conv_pallas: the eval segment
with the running-statistics affine, and the train forward with the batch
statistics' affine.

K2 is the one-pass backward of the train segment (convseg.py:387-500,
_bwd_kernel): from x and the output cotangent g it recomputes z and gives
dx, the nine weight-gradient taps and the per-channel sums S1, S2, dc, which
`fold_cotangents` turns into the seven cotangents (convseg.py:699-715). On
the card it is two TMA-fed wgmma kernels (dgrad, whose epilogue also writes
bf16 z to a workspace, then wgrad) and two fixed-order sums; TMA reads
bf16, so with f32 inputs the wrapper puts bf16(g) past the workspace.
K9 is the same backward at C = 256 (the reference's opt-in wide tier,
RESUNETA_CONVSEG_BWD_WIDE=1): the same kernels, each work item taking
one of two 128-channel halves of N (`k2_design`). Both take act = False
too (z = x*a + b, no ReLU mask), as _bwd_kernel's `act` does.

The train segment comes in the reference's two fused modes
(RESUNETA_FUSED_TRAIN_SEGMENT, resuneta.py:146-155):
- "1", `FusedSegment` (convseg.py:676-727, fused_segment): K1 forward, K2
  (or K9) backward;
- "2", `FusedSegmentBwdOnly` (K10, convseg.py:763-790,
  fused_segment_bwdonly): a plain forward (BN apply -> ReLU -> conv in x's
  dtype, + bias in x's dtype) with the same K2 backward, which recomputes z
  from x and so does not depend on how the forward ran.

On the card K1 is one CUDA kernel (kernels/csrc/convseg.cu, design
`K1_DESIGN`), the TMA-fed wgmma kernel that forms z once a stencil row in
shared memory, at C == Cout in {32, 64, 128} (every segment of the default
model), 256 (the opt-in wide tier's RB(256)) and 512 (the wide eval tier's
RB(512)); a work item is 128 pixels by all C output channels, at C = 256
by one 128-channel half, at C = 512 64 pixels by one 256-channel half
(`K1_ITEMS`). One launch a call. The wrapper raises on any other channel
count on every device: the reference's kernel takes C == Cout only
(convseg.py:237).

`bn_act_conv` and `segment_bwd` are the wrappers: on a CUDA tensor each
launches its CUDA kernels (kernels/csrc/convseg.cu, convseg_bwd.cu) or
raises; only a tensor on the CPU takes the plain version
(`bn_act_conv_reference`, `segment_bwd_reference`). `LAUNCHES` counts K1's
kernel launches (one a call) and `CALLS` K1 wrapper calls on any device;
`BWD_LAUNCHES` counts K2's and K9's kernel launches (four a call on the
card, as the CUDA side reports them) and `BWD_CALLS` their wrapper calls;
`WIDE_BWD_LAUNCHES` those of them at C = 256 (K9); `BWDONLY_LAUNCHES` the
launches made by FusedSegmentBwdOnly's backward (K10).

`disabled()` is the reference's scope (convseg.py:184-213): within it
`available` is False, the model takes its NHWC routing, and K3 and K4
(ops/densemm.py, ops/poolconv.py) refuse a call. The step enters it over
a group with a live space axis, where the activations are bands of rows
(parallel/axis.py), as the reference traces GSPMD programs under it.
"""

import contextlib
import contextvars
import ctypes

import torch
import torch.nn.functional as F

from ..device import check_current_device
from ..kernels import build

LAUNCHES = 0
CALLS = 0
BWD_LAUNCHES = 0
BWD_CALLS = 0
WIDE_BWD_LAUNCHES = 0
BWDONLY_LAUNCHES = 0

# K1's channel counts (C == Cout) and design: the TMA-fed wgmma kernel, its
# work item (pixels, output channels) by C (convseg.cu FwdShape PIX, NI)
K1_CHANNELS = (32, 64, 128, 256, 512)
K1_DESIGN = "tma_wgmma"
K1_ITEMS = {32: (128, 32), 64: (128, 64), 128: (128, 128), 256: (128, 128),
            512: (64, 256)}
# the backward's channel counts: K2's narrow tier and K9's wide one
BWD_CHANNELS = (32, 64, 128, 256)
# the reference's wide ceilings (convseg.py MAX_CHANNELS_FWD, _BWD_WIDE)
WIDE_FWD_MAX, WIDE_BWD_MAX = 512, 256
_fn = None
_bwd_fn = None


_DISABLED = contextvars.ContextVar("resuneta_torch_convseg_disabled",
                                   default=False)


@contextlib.contextmanager
def disabled(off=True):
    """Within (where `off`, or where an enclosing scope is): K1-K4 off,
    the segments and 1x1 convs plain PyTorch ops (module doc)."""
    token = _DISABLED.set(_DISABLED.get() or bool(off))
    try:
        yield
    finally:
        _DISABLED.reset(token)


def is_disabled():
    return _DISABLED.get()


def refuse_if_disabled(what):
    if _DISABLED.get():
        raise RuntimeError(f"{what} called inside convseg.disabled(): "
                           "K1-K4 are off there (a space-sharded step)")


def available(W, C, Cout, *, bwd=True, wide=False):
    """The model's routing predicate for the eval (bwd=False) and the train
    (bwd=True) segment: the channel part of the reference's gate
    (resuneta_tpu convseg.pallas_available, convseg.py:207-239) without its
    TPU-backend and VMEM-plan checks. C == Cout and (W*C) % 128 == 0, with
    C in {32, 64, 128} (the reference's 128 % C == 0 also admits C < 32,
    which no ResBlock of the model has) or, with `wide` (the reference's
    RESUNETA_CONVSEG_{FWD,BWD}_WIDE=1), C % 128 == 0 up to 512 for the
    eval segment and 256 for the train one. Without the plan check the
    function is the same and only the route differs: with wide=True the
    C = 256 segments at 128x128 (the 1024 px step) take K1 + K9 here,
    where the reference's planner finds no VMEM plan and runs XLA's
    conv. False inside `disabled()`."""
    if _DISABLED.get():
        return False
    if C <= 128:
        ch_ok = C in (32, 64, 128)
    else:
        ch_ok = wide and C % 128 == 0 and \
            C <= (WIDE_BWD_MAX if bwd else WIDE_FWD_MAX)
    return C == Cout and ch_ok and (W * C) % 128 == 0


@contextlib.contextmanager
def no_tf32():
    """Full-f32 convolutions and matmuls (cuDNN defaults to TF32 for f32
    convs)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def bn_act_conv_reference(x, a, b, w, bias, *, dilation, act=True):
    """The plain PyTorch version: the kernel's roundings (f32 z, bf16 z and
    w, f32 sums, f32 bias) through F.conv2d on f32 copies of the bf16
    values, with TF32 off. z = x*a + b is rounded once, as a fused
    multiply-add does: the f32 product is exact in f64, and the f64 sum
    rounds to the same f32 but for ties too rare to matter. x: (N, H, W, C);
    w: (3, 3, C, Cout) HWIO."""
    z = (x.double() * a.double() + b.double()).float()
    if act:
        z = torch.relu(z)
    z = z.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wt = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    with no_tf32():
        y = F.conv2d(z, wt, padding=dilation, dilation=dilation)
    y = y + bias.float()[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _check(x, a, b, w, bias, dilation):
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be (N, H, W, C) bf16 or f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    C = x.shape[3]
    if w.shape[:3] != (3, 3, C):
        raise ValueError(f"w must be (3, 3, {C}, Cout), got {tuple(w.shape)}")
    Cout = w.shape[3]
    if C != Cout or C not in K1_CHANNELS:
        raise ValueError(f"K1 takes C == Cout in {K1_CHANNELS}, got C={C}, "
                         f"Cout={Cout}")
    if a.shape != (C,) or b.shape != (C,) or bias.shape != (Cout,):
        raise ValueError("a, b must be (C,) and bias (Cout,)")
    if int(dilation) < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if any(t.device != x.device for t in (a, b, w, bias)):
        raise ValueError("all operands must be on x's device")


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("convseg").convseg_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def bn_act_conv(x, a, b, w, bias, *, dilation, act=True):
    """y = conv_{3x3,d,SAME}(act(x*a + b)) + bias, fused (see module doc).

    x: (N, H, W, C) bf16 or f32, contiguous; a, b: (C,); w: (3, 3, C, Cout)
    HWIO; bias: (Cout,). Returns (N, H, W, Cout) in x.dtype."""
    global CALLS, LAUNCHES
    _check(x, a, b, w, bias, dilation)
    CALLS += 1
    if x.device.type == "cpu":
        return bn_act_conv_reference(x, a, b, w, bias, dilation=dilation,
                                     act=act)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_current_device(x)
    N, H, W, C = x.shape
    Cout = w.shape[3]
    a32 = a.float().contiguous()
    b32 = b.float().contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    bias32 = bias.float().contiguous()
    y = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    for t in (x, wb, y):
        if t.data_ptr() % 16:
            raise ValueError("x, w and y must be 16-byte aligned")
    fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), a32.data_ptr(), b32.data_ptr(), wb.data_ptr(),
            bias32.data_ptr(), y.data_ptr(), N, H, W, C, Cout,
            int(dilation), int(bool(act)), int(x.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f"convseg kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return y


# ------------------------------------------------------------ K2 backward

def segment_affine(gamma, beta, mean, var, eps=1e-3):
    """(a, b, invstd) of the train segment in _affine's order
    (convseg.py:650-653): a = γ·invstd, b = β − mean·a. Not bn_affine's
    β − mean·γ·invstd: the f32 roundings differ."""
    invstd = torch.rsqrt(var.float() + eps)
    a = gamma * invstd
    return a, beta - mean * a, invstd


def segment_bwd_reference(x, g, a, b, mean, invstd, w, *, dilation,
                          act=True):
    """The plain PyTorch version of K2 and K9, with the TPU kernel's
    roundings: z_pre = x*a + b rounded once to f32 (as in K1), z =
    act(z_pre) and the taps in bf16, g cast to x's dtype and then to bf16
    for both products, f32 sums (an f32 convolution_backward of the bf16
    values, TF32 off: the products of bf16 values are exact in f32), the
    ReLU mask from the f32 z_pre (none when act is False), dx = dz_pre·a in
    x's dtype, dc from g in x's dtype.

    Returns (dx, dw (3, 3, C, Cout) f32, vec (3, C) f32 = [S1, S2, dc])."""
    d = int(dilation)
    zp = (x.double() * a.double() + b.double()).float()
    z = torch.relu(zp) if act else zp
    zb = z.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    gx = g.to(x.dtype)
    gb = gx.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wt = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    with no_tf32():
        dz, dw, _ = torch.ops.aten.convolution_backward(
            gb, zb, wt, None, [1, 1], [d, d], [d, d], False, [0, 0], 1,
            [True, True, False])
    dz = dz.permute(0, 2, 3, 1)
    if act:
        dz = torch.where(zp > 0, dz, torch.zeros((), device=x.device))
    dims = (0, 1, 2)
    xhat = (x.float() - mean) * invstd
    vec = torch.stack([dz.sum(dims), (dz * xhat).sum(dims),
                       gx.float().sum(dims)])
    return (dz * a).to(x.dtype), dw.permute(2, 3, 1, 0), vec


def k2_design(C):
    """Which CUDA kernels a K2 / K9 call with C channels launches:
    "tma_wgmma" (TMA-fed wgmma dgrad and wgrad, at every C the backward
    takes; at C = 256 in two 128-channel halves of N)."""
    if C not in BWD_CHANNELS:
        raise ValueError(f"C={C}: the segment backward takes C in "
                         f"{BWD_CHANNELS}")
    return "tma_wgmma"


def _check_bwd(x, g, a, b, mean, invstd, w, dilation):
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be (N, H, W, C) bf16 or f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g must match x: {tuple(g.shape)} {g.dtype} vs "
                         f"{tuple(x.shape)} {x.dtype}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous NHWC")
    C = x.shape[3]
    if C not in BWD_CHANNELS:
        raise ValueError(f"C={C}: the segment backward takes C in "
                         f"{BWD_CHANNELS}")
    if w.shape != (3, 3, C, C):
        raise ValueError(f"w must be (3, 3, {C}, {C}), got {tuple(w.shape)}")
    if any(t.shape != (C,) for t in (a, b, mean, invstd)):
        raise ValueError("a, b, mean, invstd must be (C,)")
    if int(dilation) < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if any(t.device != x.device for t in (g, a, b, mean, invstd, w)):
        raise ValueError("all operands must be on x's device")


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = build.load("convseg_bwd")
        ws = lib.convseg_backward_workspace
        ws.argtypes = [ctypes.c_int] * 4
        ws.restype = ctypes.c_longlong
        fn = lib.convseg_backward
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = (ws, fn)
    return _bwd_fn


def segment_bwd(x, g, a, b, mean, invstd, w, *, dilation, act=True):
    """K2 (C in {32, 64, 128}) and K9 (C = 256): the one-pass backward of
    the train segment (see module doc).

    x, g: (N, H, W, C) bf16 or f32, contiguous, g in x's dtype; a, b, mean,
    invstd: (C,) f32; w: (3, 3, C, C) HWIO; act: the forward's ReLU.
    Returns (dx in x.dtype, dw (3, 3, C, C) f32, vec (3, C) f32 = [S1, S2,
    dc])."""
    global BWD_CALLS, BWD_LAUNCHES, WIDE_BWD_LAUNCHES
    _check_bwd(x, g, a, b, mean, invstd, w, dilation)
    BWD_CALLS += 1
    if x.device.type == "cpu":
        return segment_bwd_reference(x, g, a, b, mean, invstd, w,
                                     dilation=dilation, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_current_device(x)
    N, H, W, C = x.shape
    vecs = [t.float().contiguous() for t in (a, b, mean, invstd)]
    # wT[t, o, c] = w[t, c, o]: the dgrad GEMM's B operand, row-major (one
    # copy kernel casts and transposes)
    wT = torch.empty((3, 3, C, C), dtype=torch.bfloat16, device=x.device)
    wT.copy_(w.permute(0, 1, 3, 2))
    dx = torch.empty_like(x)
    dw = torch.empty((3, 3, C, C), dtype=torch.float32, device=x.device)
    vec = torch.empty((3, C), dtype=torch.float32, device=x.device)
    ws_floats, fn = _bwd_kernel()
    ws = ws_floats(N, H, W, C)
    # the kernels read g through TMA in bf16: with f32 inputs bf16(g) goes
    # past their own workspace (zb, the partials)
    gb_floats = N * H * W * C // 2 if x.dtype == torch.float32 else 0
    work = torch.empty(ws + gb_floats, dtype=torch.float32, device=x.device)
    if gb_floats:
        work[ws:].view(torch.bfloat16).view(g.shape).copy_(g)
    for t in (x, g, wT, dx, work):
        if t.data_ptr() % 16:
            raise ValueError("x, g, w, dx and the workspace must be 16-byte "
                             "aligned")
    n = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in vecs),
            wT.data_ptr(), dx.data_ptr(), dw.data_ptr(), vec.data_ptr(),
            work.data_ptr(), N, H, W, C, int(dilation), int(bool(act)),
            int(x.dtype == torch.bfloat16), ctypes.byref(n), stream)
    BWD_LAUNCHES += n.value
    if C > 128:
        WIDE_BWD_LAUNCHES += n.value
    if rc != 0:
        raise RuntimeError(f"convseg_bwd kernel launch failed: cudaError {rc}")
    return dx, dw, vec


def fold_cotangents(dx, dw, vec, gamma, invstd):
    """(dx, dW, [S1, S2, dc]) -> the seven cotangents of FusedSegment's
    inputs (x, γ, β, mean, var, w, bias) (convseg.py:699-715):
    dγ = S2, dβ = S1, dmean = −γ·invstd·S1, dvar = −½·γ·invstd²·S2."""
    s1, s2, dc = vec
    return (dx, s2, s1, -gamma * invstd * s1,
            -0.5 * gamma * invstd * invstd * s2, dw, dc)


def _segment_backward(ctx, g):
    """K2/K9 + fold_cotangents from the saved (x, γ, β, mean, var, w): the
    backward of both train-segment modes (convseg.py:718-724)."""
    x, gamma, beta, mean, var, w = ctx.saved_tensors
    a, b, invstd = segment_affine(gamma, beta, mean, var, ctx.eps)
    dx, dw, vec = segment_bwd(x, g.to(x.dtype).contiguous(), a, b, mean,
                              invstd, w, dilation=ctx.dilation, act=ctx.act)
    return fold_cotangents(dx, dw, vec, gamma, invstd) + (None,) * 3


class FusedSegment(torch.autograd.Function):
    """Train-mode BN -> act -> dilated 3x3 conv (segment mode "1"):

        y = conv_{3x3,d,SAME}(act((x − mean)·rsqrt(var+eps)·γ + β)) + bias

    act the ReLU or the identity; forward = K1 on the affine (a, b) of the
    batch statistics, backward = K2 (K9 at C = 256) + fold_cotangents. mean
    and var come from bn_stats outside (shared by a ResBlock's branches);
    their cotangents carry on through autograd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, w, bias, dilation, eps, act):
        a, b, _ = segment_affine(gamma, beta, mean, var, eps)
        ctx.save_for_backward(x, gamma, beta, mean, var, w)
        ctx.dilation, ctx.eps, ctx.act = dilation, eps, act
        return bn_act_conv(x, a, b, w, bias, dilation=dilation, act=act)

    backward = staticmethod(_segment_backward)


class FusedSegmentBwdOnly(torch.autograd.Function):
    """K10, segment mode "2" (convseg.py:763-790, fused_segment_bwdonly):
    the same function as FusedSegment with a plain forward, op for op as
    the reference's (convseg.py:771-780): z = x·a + b in f32, act, cast to
    x's dtype, a conv in x's dtype (cuDNN on the card), + bias cast to x's
    dtype; and the backward of FusedSegment (K2, which recomputes z from
    x). `BWDONLY_LAUNCHES` counts the K2 launches of this backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, w, bias, dilation, eps, act):
        a, b, _ = segment_affine(gamma, beta, mean, var, eps)
        ctx.save_for_backward(x, gamma, beta, mean, var, w)
        ctx.dilation, ctx.eps, ctx.act = dilation, eps, act
        return bwdonly_forward(x, a, b, w, bias, dilation=dilation, act=act)

    @staticmethod
    def backward(ctx, g):
        global BWDONLY_LAUNCHES
        before = BWD_LAUNCHES
        out = _segment_backward(ctx, g)
        BWDONLY_LAUNCHES += BWD_LAUNCHES - before
        return out


def bwdonly_forward(x, a, b, w, bias, *, dilation, act=True):
    """K10's plain forward (convseg.py:771-780) on NHWC x: z =
    act(f32(x)·a + b) cast to x's dtype, conv_{3x3,d,SAME} in x's dtype,
    + bias cast to x's dtype. Returns NHWC in x's dtype."""
    z = x.float() * a + b
    if act:
        z = torch.relu(z)
    z = z.to(x.dtype).permute(0, 3, 1, 2)
    wt = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(z, wt, padding=dilation, dilation=dilation)
    y = y + bias.to(x.dtype)[:, None, None]
    return y.permute(0, 2, 3, 1)


def fused_segment(x, gamma, beta, mean, var, w, bias, *, dilation, eps=1e-3,
                  act=True, bwd_only=False):
    """x: (N, H, W, C) contiguous; gamma, beta, mean, var, bias: (C,) f32;
    w: (3, 3, C, C) HWIO. Segment mode "1" (FusedSegment) or, with
    bwd_only, "2" (FusedSegmentBwdOnly). Returns (N, H, W, C) in
    x.dtype."""
    fn = FusedSegmentBwdOnly if bwd_only else FusedSegment
    return fn.apply(x, gamma, beta, mean, var, w, bias, dilation, eps, act)
