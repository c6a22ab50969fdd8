"""The yardstick: the card's peaks, and the operations and bytes of the
model and of single kernels, counted from the configuration's layer
shapes (reference/model.py's topology), never from the program.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s in
bf16, 495 in TF32, 67 in float32 outside the tensor cores; 3.35 TB/s of
HBM3.

Model FLOPs count the convolutions' multiply-adds x 2: a forward at the
shapes the model needs (a PSP level's and an UpSampleConv's 1x1 conv at
the pooled or pre-upsample size), x 3 for forward and backward, where
the stem, whose input needs no gradient, counts x 2. Normalisation,
activations, pooling, the losses, the labels and the optimizer are not
counted, nor anything computed again.
"""

from reference.model import DECODER, ENCODER, psp_levels

PEAK_FLOPS = {"bf16": 989e12, "tf32": 494.7e12, "f32": 66.9e12}
PEAK_BYTES = 3.35e12


def convs(cfg, P):
    """[(name, cin, cout, k, out_h, out_w)] of one P x P patch's forward."""
    out = [("Conv_0", cfg["in_channels"], 32, 1, P, P)]

    def psp(name, c, s):
        levels = psp_levels(cfg["img_size"])
        for i, k in enumerate(levels):
            out.append((f"{name}.ConvBN_{i}", c, c // 4, 1, s // k, s // k))
        out.append((f"{name}.ConvBN_{len(levels)}",
                    c // 4 * len(levels) + c, c, 1, s, s))

    prev, s = 32, P
    for i, (f, dils) in enumerate(ENCODER):
        if i:
            s //= 2
            out.append((f"Conv_{i}", prev, f, 1, s, s))
        out += [(f"ResBlockA_{i}.Conv_{j}", f, f, 3, s, s)
                for j in range(2 * len(dils))]
        prev = f
    psp("PSPPooling_0", 1024, s)
    skips = [f for f, _ in ENCODER[:5]][::-1]
    for i, ((up, f, dils), skip) in enumerate(zip(DECODER, skips)):
        out.append((f"UpSampleConv_{i}", prev, up, 1, s, s))
        s *= 2
        out.append((f"Combine_{i}", up + skip, f, 1, s, s))
        out += [(f"ResBlockA_{6 + i}.Conv_{j}", f, f, 3, s, s)
                for j in range(2 * len(dils))]
        prev = f
    out.append(("Combine_5", 64, 32, 1, P, P))
    psp("PSPPooling_1", 32, P)
    nc = cfg["num_classes"]
    heads = [("seg1", 32, 3), ("seg2", 32, 3), ("seg3", nc, 1),
             ("Conv_6", 32, 3), ("Conv_7", nc, 1), ("Conv_8", 32, 3),
             ("Conv_9", 32, 3), ("Conv_10", nc, 1)]
    if cfg["color_head"]:
        heads.append(("Conv_11", 3, 1))
    out += [(n, 32, cout, k, P, P) for n, cout, k in heads]
    return out


def _macs(c):
    _, cin, cout, k, h, w = c
    return h * w * cout * cin * k * k


def forward_flops(cfg, P):
    """FLOPs of one P x P patch's forward."""
    return 2 * sum(_macs(c) for c in convs(cfg, P))


def train_flops(cfg, P):
    """FLOPs of one P x P patch's forward and backward."""
    cs = convs(cfg, P)
    return 6 * sum(_macs(c) for c in cs) - 2 * _macs(cs[0])


def segments(cfg, P):
    """The fused 3x3 segments of a P x P forward (BN apply, ReLU and the
    dilated conv of a ResBlock branch), where K1 and K2's gate holds:
    C in {32, 64, 128} and (W * C) % 128 == 0. [(C, H, W, dilation)]."""
    out = []
    levels = [(f, dils, P >> i) for i, (f, dils) in enumerate(ENCODER)]
    levels += [(f, dils, P >> (4 - i)) for i, (_, f, dils) in
               enumerate(DECODER)]
    for f, dils, s in levels:
        if f in (32, 64, 128) and (s * f) % 128 == 0:
            out += [(f, s, s, d) for d in dils for _ in range(2)]
    return out


def k1_seconds(N, H, W, C, elem_bytes):
    """The least time of one K1 call: BN apply, ReLU and the dilated 3x3
    conv of (N, H, W, C) into C channels; x read and y written once, the
    bf16 taps and the f32 affine and bias read once."""
    flops = 2.0 * N * H * W * C * C * 9
    nbytes = 2.0 * N * H * W * C * elem_bytes + 9 * C * C * 2 + 3 * C * 4
    return max(flops / PEAK_FLOPS["bf16"], nbytes / PEAK_BYTES)


def k2_seconds(N, H, W, C, elem_bytes):
    """The least time of one K2 call, the segment's one-pass backward: dx
    and the dW taps (two products the size of the forward's), dbias and
    the BN sums; x and g read and dx written once, the bf16 taps read,
    the f32 dW and the sums written once."""
    flops = 4.0 * N * H * W * C * C * 9
    nbytes = 3.0 * N * H * W * C * elem_bytes + 9 * C * C * (2 + 4) + \
        7 * C * 4
    return max(flops / PEAK_FLOPS["bf16"], nbytes / PEAK_BYTES)
