"""PyTorch + CUDA port of resuneta_tpu for NVIDIA Hopper (H100).

The JAX package `resuneta_tpu` is the reference; this package computes the
same functions with PyTorch and hand-written CUDA kernels. It never imports
JAX, Flax or anything of `resuneta_tpu`.

Public layouts follow the reference (NHWC). Entry points take `device=None`,
which means "cuda" and raises when no card is present; pass `device="cpu"`
to run the plain PyTorch path.

Ported so far: ISPRS sliding-window inference of the multitask ResUnet-a d6
(`infer.sliding`, `cli.test_isprs`), with the fused BN -> ReLU -> dilated
3x3 conv segment as a CUDA kernel (`ops.convseg`).
"""

__version__ = "0.1.0"
