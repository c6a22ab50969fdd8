"""The 1x1-convolution glue of the dense trunk (resuneta_tpu/ops/dense.py)
on NHWC tensors.

The reference runs these on its lane-packed (N, H, W*C) view, which holds
the same bytes as NHWC; here they take and return (N, H, W, C) tensors and
route every 1x1 convolution through K3 (ops/densemm.py) or K4
(ops/poolconv.py). Weights are (cin, cout) f32 matrices, a concat's parts
stacked in order; biases (cout,) f32. `max_pool` (the tie-splitting pool)
and `upsample_nearest` are defined beside the plain versions that use
them. The reference's `to_dense`, `to_nhwc`, `kron_block` and `bn_apply`
are layout work of the TPU and have no counterpart.
"""

from . import densemm, poolconv
from .densemm import upsample_nearest  # noqa: F401  (dense.py:195)
from .poolconv import max_pool  # noqa: F401  (dense.py:184)


def conv1x1(x, w, bias, *, act_in=False):
    """1x1 conv (dense.py:37), a ReLU on the input where act_in: K3 with
    one part."""
    return densemm.dense_mm([x], w, bias, acts=(act_in,))


def downsample2_conv1x1(x, w, bias):
    """Stride-2 1x1 conv (dense.py:93): (N, H, W, cin) -> (N, H/2, W/2,
    cout) on the even rows and columns. K3 reads the part with a stride of
    2 instead of the reference's pixel-pair view against [W; 0], which
    would double the products: its backward writes dx at full resolution,
    zero at the odd rows and columns."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"downsample2 needs even H and W, got "
                         f"{tuple(x.shape)}")
    return densemm.dense_mm([x], w, bias, strides=(2,))


def concat_conv1x1(parts, w, bias):
    """1x1 conv over the channel concat of parts (dense.py:115) without
    materialising it. parts: [(x, act, ups)], x of (N, H/ups, W/ups, cin);
    act fuses a ReLU on that part, ups > 1 a nearest upsample of it."""
    xs = [p[0] for p in parts]
    return densemm.dense_mm(xs, w, bias, acts=[p[1] for p in parts],
                            ups=[p[2] for p in parts])


def pool_conv1x1(x, w, bias, *, k):
    """k x k max pool -> 1x1 conv (dense.py:165): K4 for k > 1, K3 for
    k == 1."""
    if k == 1:
        return conv1x1(x, w, bias)
    return poolconv.pool_conv(x, w, bias, k=k)
