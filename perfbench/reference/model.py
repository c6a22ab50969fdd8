"""Plain float32 ResUnet-a d6 (Diakogiannis et al., arXiv:1904.00592), the
benchmark's reference: the forward of the multitask model in plain
PyTorch operations, NCHW, no kernels, no fusion, no routing.

Topology (the port's, which follows the upstream Keras model2.py):
  stem 1x1 conv 32
  encoder: RB(32,[1,3,15,31]) -> s2 1x1 64 -> RB(64,[1,3,15,31])
           -> s2 128 -> RB(128,[1,3,15]) -> s2 256 -> RB(256,[1,3,15])
           -> s2 512 -> RB(512,[1]) -> s2 1024 -> RB(1024,[1])
  mid:     PSPPooling(1024), ReLU
  decoder: 5 x {1x1 ConvBN then nearest x2 -> Combine(skip) -> ResBlock}
  final:   Combine(stem) -> PSPPooling(32), ReLU -> heads
           seg, bound from the PSP output; dist, color from the Combine's
A ResBlock is x + the sum over its dilations of BN -> ReLU -> conv(d) ->
BN -> ReLU -> conv(d). BatchNorm: eps 1e-3, biased batch variance in
training, the running statistics in eval. A PSP level max-pools by k
(levels 1, 2 and, from a build size of 128 and 256 px, 4 and 8), takes a
1x1 ConvBN to a quarter of the channels and upsamples by k; its 1x1 conv
runs before the upsample, which is the same arithmetic (a 1x1 conv of a
nearest upsample is the upsample of the conv, and the BN statistics of a
tensor whose pixels are each repeated k*k times are the small one's).
UpSampleConv likewise takes its ConvBN before the x2.

Parameter names are the port's state_dict names, so one set of weights,
made by the benchmark from its seed, loads into both.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Precision

ENCODER = ((32, (1, 3, 15, 31)), (64, (1, 3, 15, 31)), (128, (1, 3, 15)),
           (256, (1, 3, 15)), (512, (1,)), (1024, (1,)))
DECODER = ((256, 512, (1,)), (128, 256, (1, 3, 15)), (64, 128, (1, 3, 15)),
           (32, 64, (1, 3, 15, 31)), (16, 32, (1, 3, 15, 31)))
EPS = 1e-3


def psp_levels(img_size):
    return [1, 2] + ([4] if img_size >= 128 else []) + \
        ([8] if img_size >= 256 else [])


def layout(cfg):
    """[(name, shape, kind)] of every parameter and BN buffer, in a fixed
    order; kind is "conv_w", "zeros" or "ones"."""
    out = []

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv_w"))
        out.append((f"{name}.bias", (cout,), "zeros"))

    def bn(name, c):
        out.extend([(f"{name}.scale", (c,), "ones"),
                    (f"{name}.bias", (c,), "zeros"),
                    (f"{name}.mean", (c,), "zeros"),
                    (f"{name}.var", (c,), "ones")])

    def convbn(name, cin, cout):
        conv(f"{name}.Conv_0", cin, cout, 1)
        bn(f"{name}.BatchNorm_0", cout)

    def resblock(name, c, dils):
        for j in range(2 * len(dils)):
            bn(f"{name}.BatchNorm_{j}", c)
            conv(f"{name}.Conv_{j}", c, c, 3)

    def psp(name, c):
        levels = psp_levels(cfg["img_size"])
        for i in range(len(levels)):
            convbn(f"{name}.ConvBN_{i}", c, c // 4)
        convbn(f"{name}.ConvBN_{len(levels)}", c // 4 * len(levels) + c, c)

    conv("Conv_0", cfg["in_channels"], 32, 1)
    prev = 32
    for i, (f, dils) in enumerate(ENCODER):
        if i:
            conv(f"Conv_{i}", prev, f, 1)
        resblock(f"ResBlockA_{i}", f, dils)
        prev = f
    psp("PSPPooling_0", 1024)
    skips = [f for f, _ in ENCODER[:5]][::-1]
    for i, ((up, f, dils), skip) in enumerate(zip(DECODER, skips)):
        convbn(f"UpSampleConv_{i}.ConvBN_0", prev, up)
        convbn(f"Combine_{i}.ConvBN_0", up + skip, f)
        resblock(f"ResBlockA_{6 + i}", f, dils)
        prev = f
    convbn("Combine_5.ConvBN_0", 64, 32)
    psp("PSPPooling_1", 32)
    nc = cfg["num_classes"]
    for name, k, cout in (("seg1", 3, 32), ("seg2", 3, 32), ("seg3", 1, nc),
                          ("Conv_6", 3, 32), ("Conv_7", 1, nc),
                          ("Conv_8", 3, 32), ("Conv_9", 3, 32),
                          ("Conv_10", 1, nc)):
        conv(name, 32, cout, k)
    if cfg["color_head"]:
        conv("Conv_11", 32, 3, 1)
    return out


def glorot_limit(shape):
    """Glorot-uniform's bound of an OIHW kernel."""
    o, i, kh, kw = shape
    return math.sqrt(6.0 / (i * kh * kw + o * kh * kw))


class ResUnetA:
    """The reference forward over a dict of float32 tensors `p` (layout's
    names). `train` normalises with batch statistics, else with the
    running ones. `prec` sets the convolutions' arithmetic."""

    def __init__(self, cfg, p, train, prec=None, stats=None):
        self.cfg, self.p, self.train = cfg, p, train
        self.prec = prec or Precision("f32")
        self.stats = stats

    def conv(self, name, x, stride=1, dilation=1):
        return self.prec.conv(x, self.p[f"{name}.weight"],
                              self.p[f"{name}.bias"], stride, dilation)

    def bn(self, name, x, relu):
        p = self.p
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if self.stats is not None:
                self.stats[name] = (mean, var)
        else:
            mean, var = p[f"{name}.mean"], p[f"{name}.var"]
        scale = p[f"{name}.scale"] * torch.rsqrt(var + EPS)
        y = (x - mean[:, None, None]) * scale[:, None, None] + \
            p[f"{name}.bias"][:, None, None]
        return torch.relu(y) if relu else y

    def convbn(self, name, x, relu=False):
        return self.bn(f"{name}.BatchNorm_0", self.conv(f"{name}.Conv_0", x),
                       relu)

    def resblock(self, name, x, dils):
        """In training a block keeps only its input for the backward and
        computes its inside again there, so that a large batch fits."""
        if self.train and torch.is_grad_enabled():
            return checkpoint(self._resblock, name, x, dils,
                              use_reentrant=False)
        return self._resblock(name, x, dils)

    def _resblock(self, name, x, dils):
        out = x
        for i, d in enumerate(dils):
            b = x
            for j in (2 * i, 2 * i + 1):
                b = self.conv(f"{name}.Conv_{j}",
                              self.bn(f"{name}.BatchNorm_{j}", b, True),
                              dilation=d)
            out = out + b
        return out

    def psp(self, name, x):
        levels = psp_levels(self.cfg["img_size"])
        parts = []
        for i, k in enumerate(levels):
            y = F.max_pool2d(x, k) if k > 1 else x
            y = self.convbn(f"{name}.ConvBN_{i}", y)
            parts.append(F.interpolate(y, scale_factor=k, mode="nearest")
                         if k > 1 else y)
        return self.convbn(f"{name}.ConvBN_{len(levels)}",
                           torch.cat(parts + [x], dim=1), relu=True)

    def combine(self, name, dec, skip):
        return self.convbn(f"{name}.ConvBN_0",
                           torch.cat([torch.relu(dec), skip], dim=1))

    def __call__(self, image):
        """image: (N, H, W, C) float32. Returns the heads as NHWC float32
        probabilities ({"seg", "bound", "dist"[, "color"]}) and the seg
        logits, NHWC, under "seg_logits"."""
        x = image.permute(0, 3, 1, 2).float()
        c1 = x = self.conv("Conv_0", x)
        skips = []
        for i, (_, dils) in enumerate(ENCODER):
            if i:
                x = self.conv(f"Conv_{i}", x, stride=2)
            x = self.resblock(f"ResBlockA_{i}", x, dils)
            skips.append(x)
        x = self.psp("PSPPooling_0", x)
        for i, ((_, _, dils), skip) in enumerate(zip(DECODER, skips[4::-1])):
            x = F.interpolate(self.convbn(f"UpSampleConv_{i}.ConvBN_0", x),
                              scale_factor=2, mode="nearest")
            x = self.combine(f"Combine_{i}", x, skip)
            x = self.resblock(f"ResBlockA_{6 + i}", x, dils)
        x_comb = self.combine("Combine_5", x, c1)
        x_psp = self.psp("PSPPooling_1", x_comb)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        s = torch.relu(self.conv("seg1", x_psp))
        s = torch.relu(self.conv("seg2", s))
        logits = self.conv("seg3", s)
        out = {"seg": nhwc(torch.softmax(logits, dim=1)),
               "seg_logits": nhwc(logits)}
        b = torch.relu(self.conv("Conv_6", x_psp))
        out["bound"] = nhwc(torch.sigmoid(self.conv("Conv_7", b)))
        d = torch.relu(self.conv("Conv_8", x_comb))
        d = torch.relu(self.conv("Conv_9", d))
        out["dist"] = nhwc(torch.softmax(self.conv("Conv_10", d), dim=1))
        if self.cfg["color_head"]:
            out["color"] = nhwc(torch.sigmoid(self.conv("Conv_11", x_comb)))
        return out
