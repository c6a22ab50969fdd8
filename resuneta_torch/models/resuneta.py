"""ResUnet-a d6 multitask model (resuneta_tpu/models/resuneta.py), eval and
train mode.

Topology (ResUnet_a/model2.py:14-193):

  stem 1x1 conv 32
  encoder: RB(32,[1,3,15,31]) -> s2 1x1 64 -> RB(64,[1,3,15,31])
           -> s2 128 -> RB(128,[1,3,15]) -> s2 256 -> RB(256,[1,3,15])
           -> s2 512 -> RB(512,[1]) -> s2 1024 -> RB(1024,[1])
  mid:     PSPPooling(1024) + ReLU
  decoder: 5 x {nearest-up x2 + 1x1 ConvBN -> Combine(skip) -> ResBlock}
  final:   Combine(stem) -> PSPPooling(32) + ReLU -> heads
           seg, bound from x_psp; dist, color from x_comb (pre-PSP)

A ResBlock is identity + the SUM of its dilation branches, each
BN -> ReLU -> conv(d) -> BN -> ReLU -> conv(d). Where the reference's gate
holds (C == Cout in {32, 64, 128}, (W*C) % 128 == 0) each BN -> ReLU -> 3x3
conv segment runs fused (ops/convseg.py): in eval K1 on the running
statistics' affine, in train `FusedSegment` (K1 forward on the batch
statistics, K2 backward). Elsewhere the segment is x*a + b -> ReLU -> conv
(eval) or the closed-form BN apply -> conv (train) in the compute dtype.

Train mode runs one of the reference's two routings (resuneta.py:502-523,
:542-623), chosen by `dense_trunk`. In both, every first BN of a
ResBlock's branches normalises the block input with ONE shared statistics
pass (each still updates its own running buffers), the 1x1 ConvBNs use
batch statistics, and by default the heads are plain convs (segment mode
"1", tail mode "0" or "2").
- NHWC (what the reference runs off the TPU): every 1x1 conv is a cuDNN
  conv, PSP pools through max_pool2d, concat and upsample materialise.
- Dense trunk (the reference's TPU default, and the card's here): the
  shallow encoder's stride-2 1x1 convs, the shallow decoder's
  UpSampleConv/Combine (UpSampleConv's x2 folded into Combine's product,
  relu(dec) fused) and the final Combine + PSPPooling run through K3
  (ops/densemm.py, over concat parts, no concat or upsample materialised)
  and the PSP's pooled levels through K4 (ops/poolconv.py, pool fused,
  ties splitting the gradient); the deep levels (C >= 256) and the heads
  stay as in NHWC. The parameter tree is the same in both.
The reference's opt-in modes, its environment switches, are constructor
arguments here, off by default:
- `segment_mode` (RESUNETA_FUSED_TRAIN_SEGMENT, resuneta.py:146-155,
  :319-334): "1" the fused segment above; "0" every train segment is the
  BN apply -> ReLU -> conv; "2" (K10) a plain forward with K2's backward
  (convseg.FusedSegmentBwdOnly). "0" and "2" switch the dense trunk and
  the dense tail off (resuneta.py:518-519, :650).
- `fwd_wide`, `bwd_wide` (RESUNETA_CONVSEG_{FWD,BWD}_WIDE=1,
  convseg.py:224-235): the eval segments with C % 128 == 0 up to 512
  (RB(256), RB(512)) through K1, the train ones up to 256 (RB(256))
  through K1 + K9.
- `dense_tail` (RESUNETA_DENSE_TAIL, resuneta.py:615-653): None today's
  tail (mode "2" on the dense trunk, "0" in NHWC); "0" the NHWC Combine,
  PSP and heads; "2" Combine_5 and PSPPooling_1 through K3/K4 and the NHWC
  heads; "1" that and the five 3x3 head convs as fused segments on an
  identity affine (K1 + K2; seg1, Conv_6 and Conv_8 without the ReLU),
  the 5- and 3-channel 1x1 logits staying plain convs (resuneta.py:701-775).
In eval a BN after a 1x1 conv folds into the conv weights (epilogue). PSP
pool levels are gated on the build-time img_size, not on the input.

Height-sharded over a space axis (parallel/axis.py; the reference's GSPMD
over a (data, space) mesh), every tensor is a band of rows: the 3x3 convs
read halos, the stride-2 1x1 convs and the nearest upsamples stay local,
a PSP level whose pool is taller than the band runs on the gathered
planes, and the kernels K1-K4 are off (convseg.disabled), as the
reference's GSPMD trace has them (resuneta_tpu/parallel/mesh.py:18-36).

Module and parameter names mirror the Flax tree (Conv_0.., ResBlockA_0..,
BatchNorm_0.., ConvBN_0.., seg1..3) so convert.from_flax maps one onto the
other. Public layout is NHWC; inside, tensors are NCHW in channels_last
memory format (the same bytes). Params and BN statistics are float32; the
compute dtype is `dtype`.
"""

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..ops import convseg
from ..ops import dense as dops
from ..ops.fused_bn import bn_apply, bn_stats
from ..parallel import axis
from .norm import BatchNorm, nhwc, running_stats_frozen

_REMAT = contextvars.ContextVar("resuneta_torch_remat", default=None)


@contextlib.contextmanager
def remat(policy):
    """Within: each block that a train-mode forward hands to `checkpointed`
    runs under non-reentrant torch.utils.checkpoint with the selective
    `policy` (a create_selective_checkpoint_contexts policy function;
    train/steps.py SAVE_CONVS), the counterpart of the reference's
    jax.checkpoint of the forward (steps.py:151-152)."""
    token = _REMAT.set(policy)
    try:
        yield
    finally:
        _REMAT.reset(token)


def checkpointed(fn, *args, **kw):
    """fn(*args, **kw); inside `remat` with grad on, under checkpoint: the
    ops `policy` saves keep their outputs, the rest is freed and rerun
    just before the block's backward. The rerun sees the data and space
    axes and the kernels' `convseg.disabled` scope of the forward (the
    backward may run on autograd's thread, where the step's context is
    not set), so sync-BN reduces over the same ranks again and the halos
    and routes are the forward's, and it leaves the BN running buffers
    alone (updated once, by the forward)."""
    policy = _REMAT.get()
    if policy is None or not torch.is_grad_enabled():
        return fn(*args, **kw)
    group = axis.current_group()
    off = convseg.is_disabled()
    runs = []

    def run(*a):
        rerun = bool(runs)
        runs.append(True)
        with axis.data_axis(group), convseg.disabled(off), \
                running_stats_frozen(rerun):
            return fn(*a, **kw)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, policy))


def _glorot_uniform(shape, generator):
    """OIHW weights, glorot-uniform over fan_in = I*kh*kw, fan_out = O*kh*kw
    (flax glorot_uniform on the HWIO kernel)."""
    o, i, kh, kw = shape
    limit = math.sqrt(6.0 / (i * kh * kw + o * kh * kw))
    w = torch.empty(shape)
    w.uniform_(-limit, limit, generator=generator)
    return w


def _upsample_nearest(x, k):
    return x if k == 1 else F.interpolate(x, scale_factor=k, mode="nearest")


class Conv(nn.Module):
    """Convolution with the reference's fusion hooks (resuneta.py:54-189):

    * prologue=(a, b): a preceding BN's affine (eval); act(x*a + b) -> conv
      runs through K1 where convseg.available(bwd=False, wide=fwd_wide)
      holds;
    * bn_raw=(scale, bias, mean, var): a preceding train-mode BN and act
      (resuneta.py:137-155); by segment_mode, where
      convseg.available(wide=bwd_wide) holds, the segment runs as
      convseg.FusedSegment (K1 + K2/K9, "1") or FusedSegmentBwdOnly (a
      plain forward + K2/K9, "2"), and otherwise (and in mode "0") as the
      closed-form BN apply -> act -> conv;
    * epilogue=(a, b): a following BN's affine folded into the weights,
      conv(x)*a + b == conv with (W*a, bias*a + b), then ReLU if act.

    Under a live space axis (parallel/axis.py) x is a band of rows and a
    3x3 conv reads axis.halo(x, d): the d rows above and below from the
    neighbouring bands, zeros past the image, in place of the row padding.
    """

    def __init__(self, in_features, features, kernel_size=3, dilation=1,
                 stride=1, dtype=torch.float32, generator=None,
                 segment_mode="1", fwd_wide=False, bwd_wide=False):
        super().__init__()
        self.segment_mode = segment_mode
        self.fwd_wide = fwd_wide
        self.bwd_wide = bwd_wide
        k = kernel_size
        self.weight = nn.Parameter(
            _glorot_uniform((features, in_features, k, k), generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.kernel_size = k
        self.dilation = dilation
        self.stride = stride
        self.dtype = dtype

    def forward(self, x, prologue=None, epilogue=None, act=True, bn_raw=None):
        w, bias, d = self.weight, self.bias, self.dilation
        if bn_raw is not None and self.kernel_size == 3:
            scale, beta, mean, var = bn_raw
            if self.segment_mode != "0" and convseg.available(
                    x.shape[3], x.shape[1], w.shape[0], wide=self.bwd_wide):
                y = convseg.fused_segment(
                    nhwc(x).contiguous(), scale, beta, mean, var,
                    w.permute(2, 3, 1, 0), bias, dilation=d, act=act,
                    bwd_only=self.segment_mode == "2")
                return y.permute(0, 3, 1, 2)
            x = bn_apply(nhwc(x), scale, beta, mean, var, eps=1e-3,
                         relu=act).permute(0, 3, 1, 2)
        if prologue is not None and self.kernel_size == 3:
            a, b = prologue
            if convseg.available(x.shape[3], x.shape[1], w.shape[0],
                                 bwd=False, wide=self.fwd_wide):
                # channels_last NCHW is NHWC-contiguous: no copy
                y = convseg.bn_act_conv(
                    x.permute(0, 2, 3, 1).contiguous(), a, b,
                    w.permute(2, 3, 1, 0), bias, dilation=d, act=act)
                return y.permute(0, 3, 1, 2)
            x = x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
            if act:
                x = torch.relu(x)
        if epilogue is not None:
            a, b = epilogue
            w = w * a[:, None, None, None]
            bias = bias * a + b
        dt = self.dtype
        x, pad = x.to(dt), d * (self.kernel_size // 2)
        padding = pad
        if pad and axis.space_live():
            # a band of rows: the neighbours' rows in place of the padding
            x, padding = axis.halo(x, pad), (0, pad)
        y = F.conv2d(x, w.to(dt, memory_format=torch.channels_last),
                     stride=self.stride, padding=padding, dilation=d)
        y = y + bias.to(dt)[:, None, None]
        if epilogue is not None and act:
            y = torch.relu(y)
        return y

    def dense(self, parts, pool=1):
        """The 1x1 conv on the dense trunk (resuneta.py:98-123) over
        parts [(x, act, ups)] of NCHW channels_last tensors (NHWC bytes):
        a K4 max pool -> conv where pool > 1, the stride-2 downsample
        where this conv has stride 2, else K3 over the concat of the
        parts."""
        w = self.weight[:, :, 0, 0].t()
        xs = [(nhwc(x), act, ups) for x, act, ups in parts]
        if pool > 1:
            y = dops.pool_conv1x1(xs[0][0], w, self.bias, k=pool)
        elif self.stride == 2:
            y = dops.downsample2_conv1x1(xs[0][0], w, self.bias)
        else:
            y = dops.concat_conv1x1(xs, w, self.bias)
        return y.permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """Conv (1x1 by default) -> BN; in eval the BN folds into the conv, in
    train it normalises with the conv output's batch statistics."""

    def __init__(self, in_features, features, kernel_size=1, stride=1,
                 dtype=torch.float32, act=False, generator=None):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_features, features, kernel_size, stride=stride,
                           dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(features, act=act)

    def forward(self, x, dense_parts=None, pool=1):
        """dense_parts=[(x, act, ups)]: the dense trunk's route
        (resuneta.py:209-216), the conv through K3/K4 (Conv.dense), train
        mode only."""
        if dense_parts is not None:
            return self.BatchNorm_0(self.Conv_0.dense(dense_parts, pool))
        if self.training:
            return self.BatchNorm_0(self.Conv_0(x))
        return self.Conv_0(x, epilogue=self.BatchNorm_0.affine(), act=self.act)


class ResBlockA(nn.Module):
    """identity + sum over dilations of BN->ReLU->conv(d)->BN->ReLU->conv(d)
    (resuneta.py:306-341, _generic). Branch i owns BatchNorm_{2i}, Conv_{2i},
    BatchNorm_{2i+1}, Conv_{2i+1}. In train mode every branch's first BN
    takes the block input's statistics from one shared pass. segment_mode,
    fwd_wide and bwd_wide route the segments (Conv). A subclass with
    `identity = False` sums the branches alone (variants.ResBlockV1)."""

    identity = True

    def __init__(self, features, dilation_rates, dtype=torch.float32,
                 generator=None, segment_mode="1", fwd_wide=False,
                 bwd_wide=False):
        super().__init__()
        self.dilation_rates = list(dilation_rates)
        for i, d in enumerate(self.dilation_rates):
            for j in (2 * i, 2 * i + 1):
                self.add_module(f"BatchNorm_{j}", BatchNorm(features, act=True))
                self.add_module(f"Conv_{j}", Conv(
                    features, features, 3, d, dtype=dtype, generator=generator,
                    segment_mode=segment_mode, fwd_wide=fwd_wide,
                    bwd_wide=bwd_wide))

    def forward(self, x):
        shared = bn_stats(nhwc(x)) if self.training else None
        out = x if self.identity else None
        for i in range(len(self.dilation_rates)):
            b = x
            for j in (2 * i, 2 * i + 1):
                bn = getattr(self, f"BatchNorm_{j}")
                conv = getattr(self, f"Conv_{j}")
                if self.training:
                    stats = shared if j == 2 * i else None
                    b = conv(b, bn_raw=bn(b, stats=stats, return_raw=True))
                else:
                    b = conv(b, prologue=bn.affine())
            out = b if out is None else out + b
        return out


class PSPPooling(nn.Module):
    """Pyramid pooling (model2.py:41-79): max-pool at {1,2,4,8} gated on the
    build-time width, 1x1 ConvBN to features/4, nearest upsample back,
    concat with the input, final 1x1 ConvBN. The 1x1 ConvBN runs before the
    upsample: a 1x1 conv of a nearest-upsampled tensor is the upsampled 1x1
    conv, the same arithmetic at k*k-fold less work. In train mode the BN's
    batch statistics over the upsampled tensor equal those over the small
    one (every pixel repeated k*k times leaves mean and E[x^2] unchanged;
    resuneta.py:384-390), so the order changes only f32 rounding."""

    def __init__(self, features, img_width, dtype=torch.float32, act=False,
                 generator=None):
        super().__init__()
        self.levels = [1, 2] + ([4] if img_width >= 128 else []) + \
            ([8] if img_width >= 256 else [])
        quarter = features // 4
        for i, _ in enumerate(self.levels):
            self.add_module(f"ConvBN_{i}", ConvBN(
                features, quarter, dtype=dtype, generator=generator))
        self.add_module(f"ConvBN_{len(self.levels)}", ConvBN(
            quarter * len(self.levels) + features, features, dtype=dtype,
            act=act, generator=generator))

    def forward(self, x, dense=False):
        """dense: the dense trunk's path (resuneta.py:374-423): level 1
        through K3, the pooled levels through K4, each BN on the small
        tensor, and the projection one K3 call over the levels and x with
        ups (1, 2, 4, 8, 1) at img_width 256. The reference downgrades the
        largest ups when its VMEM planner finds no plan (:411-421); a
        nearest upsample is a copy, so here every level folds into K3."""
        final = getattr(self, f"ConvBN_{len(self.levels)}")
        if dense:
            parts = [(getattr(self, f"ConvBN_{i}")(
                None, dense_parts=[(x, False, 1)], pool=k), False, k)
                for i, k in enumerate(self.levels)]
            return final(None, dense_parts=parts + [(x, False, 1)])
        parts = []
        for i, k in enumerate(self.levels):
            conv = getattr(self, f"ConvBN_{i}")
            if k > 1 and x.shape[2] % k:
                # a band of rows (parallel/axis.py) that holds no whole
                # k-row window: the level on the gathered planes, the same
                # on every rank of the space axis, and its band kept
                y = conv(F.max_pool2d(axis.gather_space(x), k))
                parts.append(axis.band(_upsample_nearest(y, k)))
                continue
            p = F.max_pool2d(x, k) if k > 1 else x
            parts.append(_upsample_nearest(conv(p), k))
        return final(torch.cat(parts + [x], dim=1))


class Combine(nn.Module):
    """relu(dec) ++ skip -> 1x1 ConvBN (model2.py:81-87)."""

    def __init__(self, dec_features, skip_features, features,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.ConvBN_0 = ConvBN(dec_features + skip_features, features,
                               dtype=dtype, generator=generator)

    def forward(self, dec, skip, dense=False, ups=1):
        """dense: one K3 call over (dec, ReLU, ups) and (skip)
        (resuneta.py:442-454); ups=2 takes dec before UpSampleConv's x2."""
        if dense:
            return self.ConvBN_0(None, dense_parts=[(dec, True, ups),
                                                    (skip, False, 1)])
        return self.ConvBN_0(torch.cat([torch.relu(dec), skip], dim=1))


class UpSampleConv(nn.Module):
    """Nearest x2 -> 1x1 ConvBN (model2.py:89-94), run as ConvBN then the
    upsample (the same arithmetic, 4x less work; in train mode the batch
    statistics of the upsampled tensor equal the small one's, see
    PSPPooling)."""

    def __init__(self, in_features, features, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, dtype=dtype,
                               generator=generator)

    def forward(self, x, dense=False):
        """dense: the ConvBN through K3, and the x2 left to the consumer
        (Combine folds it into its product; resuneta.py:481-482)."""
        if dense:
            return self.ConvBN_0(None, dense_parts=[(x, False, 1)])
        return _upsample_nearest(self.ConvBN_0(x), 2)


# encoder: (features, dilations) per level; level 0 follows the stem
_ENCODER = ((32, (1, 3, 15, 31)), (64, (1, 3, 15, 31)), (128, (1, 3, 15)),
            (256, (1, 3, 15)), (512, (1,)), (1024, (1,)))
# decoder: (up-filters, combine/ResBlock filters, dilations), deepest first
_DECODER = ((256, 512, (1,)), (128, 256, (1, 3, 15)), (64, 128, (1, 3, 15)),
            (32, 64, (1, 3, 15, 31)), (16, 32, (1, 3, 15, 31)))


class ResUnetA(nn.Module):
    """ResUnet-a d6. Input (N, H, W, in_channels) NHWC, any float dtype;
    returns NHWC float32 heads: {"seg", "bound", "dist"[, "color"]} when
    multitasking, else the seg softmax. Built in eval mode; `.train()` runs
    batch statistics and updates the BN running buffers in place.

    Weights are drawn on the CPU from `generator` (a fresh generator seeded
    0 when None; the reference's scheme: glorot-uniform convs, zero bias,
    BN scale 1, bias 0, mean 0, var 1), then moved to `device` (None means
    cuda, see device.resolve_device).

    dense_trunk picks the train-mode routing (the reference's
    `_use_dense_trunk`, resuneta.py:502-523, whose RESUNETA_DENSE_TRUNK
    becomes this argument): None, the reference's default, runs the dense
    trunk where its kernels run (the model on the card) and NHWC on the
    CPU, as the reference is off the TPU; True and False force it on and
    off. On needs the reference's geometry (H == W, W % 32 == 0, W >= 64)
    and segment mode "1"; elsewhere, and in eval, the model runs NHWC.

    segment_mode ("0", "1", "2"), fwd_wide, bwd_wide and dense_tail (None,
    "0", "1", "2") are the reference's opt-in modes (module doc); their
    defaults give the routing above. The parameter tree is the same in
    every mode, so convert.from_flax serves them all."""

    def __init__(self, num_classes, img_size=256, multitasking=True,
                 color_head=True, dtype=torch.float32, in_channels=3,
                 generator=None, device=None, dense_trunk=None,
                 segment_mode="1", fwd_wide=False, bwd_wide=False,
                 dense_tail=None):
        super().__init__()
        if segment_mode not in ("0", "1", "2"):
            raise ValueError(f"segment_mode must be '0', '1' or '2', got "
                             f"{segment_mode!r}")
        if dense_tail not in (None, "0", "1", "2"):
            raise ValueError(f"dense_tail must be None, '0', '1' or '2', "
                             f"got {dense_tail!r}")
        dev = resolve_device(device)
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.dense_trunk = dense_trunk
        self.segment_mode = segment_mode
        self.dense_tail = dense_tail
        self.num_classes = num_classes
        self.img_size = img_size
        self.multitasking = multitasking
        self.color_head = color_head
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=g)
        rb = dict(kw, segment_mode=segment_mode, fwd_wide=fwd_wide,
                  bwd_wide=bwd_wide)

        self.Conv_0 = Conv(in_channels, 32, 1, **kw)
        prev = 32
        for i, (f, dil) in enumerate(_ENCODER):
            if i:
                self.add_module(f"Conv_{i}", Conv(prev, f, 1, stride=2, **kw))
            self.add_module(f"ResBlockA_{i}", ResBlockA(f, dil, **rb))
            prev = f
        self.PSPPooling_0 = PSPPooling(1024, img_size, act=True, **kw)
        skips = [f for f, _ in _ENCODER[:5]][::-1]  # c6 .. c2 channels
        for i, ((up_f, f, dil), skip) in enumerate(zip(_DECODER, skips)):
            self.add_module(f"UpSampleConv_{i}", UpSampleConv(prev, up_f, **kw))
            self.add_module(f"Combine_{i}", Combine(up_f, skip, f, **kw))
            self.add_module(f"ResBlockA_{6 + i}", ResBlockA(f, dil, **rb))
            prev = f
        self.Combine_5 = Combine(32, 32, 32, **kw)
        self.PSPPooling_1 = PSPPooling(32, img_size, act=True, **kw)

        nc = num_classes
        if not multitasking:
            self.Conv_6 = Conv(32, nc, 1, **kw)
        else:
            self.seg1 = Conv(32, 32, 3, **kw)
            self.seg2 = Conv(32, 32, 3, **kw)
            self.seg3 = Conv(32, nc, 1, **kw)
            self.Conv_6 = Conv(32, 32, 3, **kw)   # bound
            self.Conv_7 = Conv(32, nc, 1, **kw)
            self.Conv_8 = Conv(32, 32, 3, **kw)   # dist
            self.Conv_9 = Conv(32, 32, 3, **kw)
            self.Conv_10 = Conv(32, nc, 1, **kw)
            if color_head:
                self.Conv_11 = Conv(32, 3, 1, **kw)
        self.eval()
        self.to(dev)

    def uses_dense_trunk(self, H, W):
        """The routing of a train-mode forward on H x W input (class
        doc)."""
        if not self.training or self.dense_trunk is False or \
                self.segment_mode != "1" or convseg.is_disabled():
            return False
        if H != W or W % 32 or W < 64:
            return False
        return self.dense_trunk or self.Conv_0.weight.is_cuda

    def tail_mode(self, H, W):
        """The tail of a train-mode forward on H x W input
        (resuneta.py:615-653): "0" NHWC, "2" Combine_5 and PSPPooling_1
        through K3/K4 with the NHWC heads, "1" that and the fused head
        segments. dense_tail=None gives "2" on the dense trunk, else "0";
        an explicit mode holds on the dense trunk, and without it where
        the reference's geometry does ((W*32) % 128 == 0, H and W
        multiples of 8); segment modes "0" and "2" and eval give "0"."""
        if not self.training or self.segment_mode != "1" or \
                convseg.is_disabled():
            return "0"
        dense = self.uses_dense_trunk(H, W)
        if self.dense_tail is None:
            return "2" if dense else "0"
        if dense or ((W * 32) % 128 == 0 and H % 8 == 0 and W % 8 == 0):
            return self.dense_tail
        return "0"

    def forward(self, x):
        """Under `remat` each ResBlock, PSP, UpSampleConv,
        Combine and the heads are a `checkpointed` block; the stem and the
        stride-2 convs, whose outputs are kept anyway, are not. Under a
        live space axis x is a band of rows, which must divide into the
        deepest level (H/32 whole rows a band); the kernels' scope
        (convseg.disabled, entered by the step) then gives the NHWC
        routing, and a forced dense trunk or tail raises in training."""
        axis.check_band(x.shape[1], 32, "ResUnetA")
        if self.training and convseg.is_disabled() and (
                self.dense_trunk or self.dense_tail in ("1", "2")):
            raise ValueError(
                "dense_trunk=True and dense_tail '1'/'2' run K3/K4, which "
                "are off inside convseg.disabled() (a space-sharded step)")
        dense = self.uses_dense_trunk(x.shape[1], x.shape[2])
        tail = self.tail_mode(x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2).to(self.dtype)   # NHWC bytes, channels_last
        c1 = x = self.Conv_0(x)
        skips = []
        for i in range(len(_ENCODER)):
            if i:
                conv = getattr(self, f"Conv_{i}")
                # the dense trunk's stride-2 downsamples: C < 256 in
                x = conv.dense([(x, False, 1)]) if dense and i <= 3 \
                    else conv(x)
            x = checkpointed(getattr(self, f"ResBlockA_{i}"), x)
            skips.append(x)
        x = checkpointed(self.PSPPooling_0, x)
        for i, skip in enumerate(skips[4::-1]):
            # the dense trunk's shallow decoder: UpSampleConv_{2,3,4}
            # hands Combine the tensor before its x2
            d = dense and i >= 2
            x = checkpointed(getattr(self, f"UpSampleConv_{i}"), x, dense=d)
            x = checkpointed(getattr(self, f"Combine_{i}"), x, skip,
                             dense=d, ups=2 if d else 1)
            x = checkpointed(getattr(self, f"ResBlockA_{6 + i}"), x)
        x_comb = checkpointed(self.Combine_5, x, c1, dense=tail != "0")
        x_psp = checkpointed(self.PSPPooling_1, x_comb, dense=tail != "0")
        heads = self._fused_heads if tail == "1" else self._heads
        return checkpointed(heads, x_comb, x_psp)

    def _heads(self, x_comb, x_psp):
        """resuneta.py:659-699; outputs are NHWC float32."""
        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        if not self.multitasking:
            return nhwc(torch.softmax(self.Conv_6(x_psp).float(), dim=1))
        s = torch.relu(self.seg1(x_psp))
        s = torch.relu(self.seg2(s))
        out = {"seg": nhwc(torch.softmax(self.seg3(s).float(), dim=1))}
        b = torch.relu(self.Conv_6(x_psp))
        out["bound"] = nhwc(torch.sigmoid(self.Conv_7(b).float()))
        d = torch.relu(self.Conv_8(x_comb))
        d = torch.relu(self.Conv_9(d))
        out["dist"] = nhwc(torch.softmax(self.Conv_10(d).float(), dim=1))
        if self.color_head:
            out["color"] = nhwc(torch.sigmoid(self.Conv_11(x_comb).float()))
        return out

    def _fused_heads(self, x_comb, x_psp):
        """Tail mode "1" (resuneta.py:701-775): the five 3x3 head convs as
        fused segments on an identity affine, in the reference's order,
        the ReLU between two head convs fused into the second (seg1, Conv_6
        and Conv_8 take none); the 1x1 logits stay plain convs (the
        reference's densemm rejects 5 and 3 output channels and runs them
        NHWC)."""
        C = x_psp.shape[1]
        ones = torch.ones(C, device=x_psp.device)
        zeros = torch.zeros(C, device=x_psp.device)
        # a = γ·rsqrt(var + 1e-3) = rsqrt(1) = 1 bit for bit, b = 0
        # (resuneta.py:129-131)
        identity = (ones, zeros, zeros, ones - 1e-3)

        def head3(conv, x, act):
            if convseg.available(x.shape[3], x.shape[1], C):
                return conv(x, bn_raw=identity, act=act)
            return conv(torch.relu(x) if act else x)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        if not self.multitasking:
            return nhwc(torch.softmax(self.Conv_6(x_psp).float(), dim=1))
        s = head3(self.seg2, head3(self.seg1, x_psp, False), True)
        out = {"seg": nhwc(torch.softmax(
            self.seg3(torch.relu(s)).float(), dim=1))}
        b = head3(self.Conv_6, x_psp, False)
        out["bound"] = nhwc(torch.sigmoid(self.Conv_7(torch.relu(b)).float()))
        d = head3(self.Conv_9, head3(self.Conv_8, x_comb, False), True)
        out["dist"] = nhwc(torch.softmax(
            self.Conv_10(torch.relu(d)).float(), dim=1))
        if self.color_head:
            out["color"] = nhwc(torch.sigmoid(self.Conv_11(x_comb).float()))
        return out
