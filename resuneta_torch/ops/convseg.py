"""K1: fused BN affine -> ReLU -> dilated 3x3 conv (+ bias), NHWC.

    y = conv_{3x3, dilation d, SAME zero pad}(z) + bias,  z = act(x * a + b)

z is x*a + b rounded once to f32 (a fused multiply-add, as XLA forms it),
is zero outside the image (the conv's padding of z, not act(b)) and is
rounded to bf16 once; the taps are bf16(w); products are summed in f32; the
bias is added in f32 and y is cast to x's dtype. This is
the eval-mode ResBlock branch segment (BN running-stats affine -> ReLU ->
conv), the function of resuneta_tpu/ops/pallas/convseg.py
bn_act_conv_pallas.

`bn_act_conv` is the wrapper: on a CUDA tensor it launches the CUDA kernel
(kernels/csrc/convseg.cu) or raises; only a tensor on the CPU takes the
plain version `bn_act_conv_reference`. `LAUNCHES` counts kernel launches,
`CALLS` counts wrapper calls on any device.
"""

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build

LAUNCHES = 0
CALLS = 0

MAX_CHANNELS = 512
_fn = None


def available(W, C, Cout):
    """The model's routing predicate, the reference's default eval gate
    (resuneta_tpu convseg.pallas_available(bwd=False) without its TPU
    backend and VMEM-plan checks): C == Cout, C in {32, 64, 128} and
    (W*C) % 128 == 0."""
    return C == Cout and C in (32, 64, 128) and (W * C) % 128 == 0


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
    if C % 32 or C > MAX_CHANNELS or Cout % 32:
        raise ValueError(f"C={C} and Cout={Cout} must be multiples of 32, "
                         f"C <= {MAX_CHANNELS}")
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), a32.data_ptr(), b32.data_ptr(), wb.data_ptr(),
                bias32.data_ptr(), y.data_ptr(), N, H, W, C, Cout,
                int(dilation), int(bool(act)), int(x.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"convseg kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return y
