"""Arithmetic modes of the plain reference's convolutions.

"f32" is the reference itself: float32 operands and sums, TF32 off.
The others put the reference in the program's place one precision lower,
as the controls of the output check:
- "tf32": cuDNN's TF32 products (10-bit mantissas), float32 sums;
- "bf16": operands and incoming gradients rounded to bfloat16;
- "fp8": operands scaled per tensor to float8 e4m3 (amax to 448) in the
  forward and incoming gradients to e5m2 (amax to 57344) in the backward,
  the usual recipe of float8 training; sums stay float32.
Everything but the convolutions (normalisation, activations, losses, the
optimizer) stays float32 in every mode.
"""

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "bf16", "fp8")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


@contextlib.contextmanager
def tf32(allowed):
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allowed
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _fp8(x, dtype, top):
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x * scale).to(dtype).float() / scale).to(x.dtype)


def rounded(x, mode, backward=False):
    """x as the mode holds it: an operand (forward) or a gradient."""
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "fp8":
        return _fp8(x, torch.float8_e5m2, _E5M2_MAX) if backward else \
            _fp8(x, torch.float8_e4m3fn, _E4M3_MAX)
    return x


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded; backward: straight through."""

    @staticmethod
    def forward(ctx, x, mode):
        return rounded(x, mode)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gradient(torch.autograd.Function):
    """Forward: identity; backward: the incoming gradient rounded, so both
    of the convolution's backward products take it in the mode."""

    @staticmethod
    def forward(ctx, y, mode):
        ctx.mode = mode
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, ctx.mode, backward=True), None


class Precision:
    """conv2d in one of MODES (NCHW float32 tensors). Run the forward and
    the backward inside `scope()`, which sets cuDNN's TF32 switch for the
    mode (off but in "tf32")."""

    def __init__(self, mode="f32"):
        if mode not in MODES:
            raise ValueError(f"precision mode must be one of {MODES}, got "
                             f"{mode!r}")
        self.mode = mode

    def scope(self):
        return tf32(self.mode == "tf32")

    def conv(self, x, w, b, stride=1, dilation=1):
        pad = dilation * (w.shape[-1] // 2)
        low = self.mode in ("bf16", "fp8")
        if low:
            x, w = _Operand.apply(x, self.mode), _Operand.apply(w, self.mode)
        y = F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation)
        if low and torch.is_grad_enabled():
            y = _Gradient.apply(y, self.mode)
        return y
