"""The reference's historical ResUnet-a variants (resuneta_tpu/models/
variants.py; SURVEY.md §2.1):

  ResUnetAV1     - ResUnet_a/model.py: a residual block sums its dilation
                   branches WITHOUT the identity path (model.py:26-33); the
                   PSP, the decoder and the combines have no BatchNorm
                   (model.py:35-65, 93-94) and no ReLU follows either PSP.
                   Heads as model2's.
  ResUnetALegacy - ResUnet_a/model_old.py: single task, the encoder and
                   decoder stages gated on the build-time input size
                   64/128/256/512 (model_old.py:100-125, 133-155), PSP pool
                   sizes 2/4/8/16 with 'same' pooling (model_old.py:62-76),
                   a mean-subtract predict helper (model_old.py:176-185).

`ResBlockV1` is the port's `ResBlockA` without its identity path, so its
BN -> ReLU -> dilated 3x3 conv segments take K1 (eval) and K1 + K2 (train)
on the card within `ops/convseg.available`'s shape rules, their plain
versions on the CPU, and the closed-form BN apply -> conv elsewhere. The
PSPs and the 1x1 convs are plain PyTorch, as they are plain XLA in JAX.

Modules carry the Flax auto-names (Conv_n in creation order,
ResBlockV1_n/BatchNorm_n/..., PSPPoolingV1_n, seg1-seg3), so
convert.from_flax maps every variable. Public layout NHWC, inside NCHW
channels_last; params and BN statistics f32, compute dtype `dtype`.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel import axis
from .resuneta import Conv, ResBlockA, _upsample_nearest, checkpointed


class ResBlockV1(ResBlockA):
    """Pre-activation multi-dilation block, the sum of its branches only."""

    identity = False


class _Named(nn.Module):
    """Adds children under Flax's compact auto-names (Conv_0, Conv_1, ...
    in creation order, per class name), each reachable too as the
    attribute `alias` without a second registration."""

    def _add(self, child, alias=None):
        prefix = type(child).__name__
        counts = self.__dict__.setdefault("_counts", {})
        n = counts.get(prefix, 0)
        counts[prefix] = n + 1
        self.add_module(f"{prefix}_{n}", child)
        if alias is not None:
            object.__setattr__(self, alias, child)
        return child


def _psp_levels(img_width):
    return [1, 2] + ([4] if img_width >= 128 else []) + \
        ([8] if img_width >= 256 else [])


class PSPPoolingV1(_Named):
    """PSP without BatchNorm (model.py:35-65): per level max pool -> 1x1
    conv to features/4 -> nearest upsample, concat with the input, 1x1
    conv. The levels follow the build-time width."""

    def __init__(self, features, img_width, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.levels = _psp_levels(img_width)
        quarter = features // 4
        kw = dict(dtype=dtype, generator=generator)
        self.convs = [self._add(Conv(features, quarter, 1, **kw))
                      for _ in self.levels]
        self._add(Conv(quarter * len(self.levels) + features, features, 1,
                       **kw), "out")

    def forward(self, x):
        pooled = [_upsample_nearest(conv(F.max_pool2d(x, k) if k > 1 else x),
                                    k)
                  for k, conv in zip(self.levels, self.convs)]
        return self.out(torch.cat(pooled + [x], dim=1))


class PSPPoolingLegacy(_Named):
    """Fixed pool sizes 2/4/8/16 (model_old.py:57-83): a side that is not
    a multiple of k is padded with -inf ('same' pooling), and the
    upsampled level cropped back to the input."""

    def __init__(self, features, dtype=torch.float32, generator=None):
        super().__init__()
        quarter = features // 4
        kw = dict(dtype=dtype, generator=generator)
        self.convs = [self._add(Conv(features, quarter, 1, **kw))
                      for _ in range(4)]
        self._add(Conv(4 * quarter + features, features, 1, **kw), "out")

    def forward(self, x):
        H = x.shape[2]
        pooled = []
        for k, conv in zip((2, 4, 8, 16), self.convs):
            pad = (-H) % k
            xp = F.pad(x, (0, pad, 0, pad), value=float("-inf")) if pad \
                else x
            p = _upsample_nearest(conv(F.max_pool2d(xp, k)), k)
            pooled.append(p[:, :, :H, :H])
        return self.out(torch.cat(pooled + [x], dim=1))


def _setup(generator, device):
    return (resolve_device(device), generator if generator is not None
            else torch.Generator().manual_seed(0))


class _ResUnetBase(_Named):
    """What V1 and the legacy model share: the combine (relu(dec) ++ skip
    -> 1x1 conv, no BN). Under `remat` each ResBlockV1 is a
    `checkpointed` block."""

    def _combine(self, dec, skip, conv):
        return conv(torch.cat([torch.relu(dec), skip], dim=1))


# encoder (features, dilations) and decoder (features, dilations), as in
# ResUnetA; V1's decoder level i pairs with encoder skip 4 - i
_V1_ENCODER = ((32, (1, 3, 15, 31)), (64, (1, 3, 15, 31)), (128, (1, 3, 15)),
               (256, (1, 3, 15)), (512, (1,)), (1024, (1,)))
_V1_DECODER = ((512, (1,)), (256, (1, 3, 15)), (128, (1, 3, 15)),
               (64, (1, 3, 15, 31)), (32, (1, 3, 15, 31)))


class ResUnetAV1(_ResUnetBase):
    """The reference's first ResUnet-a (ResUnet_a/model.py). Input (N, H,
    W, in_channels) NHWC; returns NHWC float32 {"seg", "bound", "dist",
    "color"} when multitasking, else the seg softmax. Built in eval mode
    on `device` (None means cuda) from `generator`'s weights (seeded 0
    when None): glorot-uniform convs, zero bias, BN 1/0/0/1."""

    def __init__(self, num_classes, img_size=256, multitasking=True,
                 dtype=torch.float32, in_channels=3, generator=None,
                 device=None):
        super().__init__()
        dev, g = _setup(generator, device)
        self.num_classes, self.img_size = num_classes, img_size
        self.multitasking, self.dtype = multitasking, dtype
        kw = dict(dtype=dtype, generator=g)
        nc = num_classes
        self._add(Conv(in_channels, 32, 1, **kw), "stem")
        self.down, self.enc = [], []
        prev = 32
        for i, (f, dil) in enumerate(_V1_ENCODER):
            if i:
                self.down.append(self._add(Conv(prev, f, 1, stride=2, **kw)))
            self.enc.append(self._add(ResBlockV1(f, dil, **kw)))
            prev = f
        self._add(PSPPoolingV1(1024, img_size, **kw), "psp")
        self.dec = []
        for (f, dil), (skip, _) in zip(_V1_DECODER, _V1_ENCODER[4::-1]):
            up = self._add(Conv(prev, f, 1, **kw))
            comb = self._add(Conv(f + skip, f, 1, **kw))
            self.dec.append((up, comb, self._add(ResBlockV1(f, dil, **kw))))
            prev = f
        self._add(Conv(64, 32, 1, **kw), "comb")
        self._add(PSPPoolingV1(32, img_size, **kw), "psp_out")
        if not multitasking:
            self._add(Conv(32, nc, 1, **kw), "logits")
        else:
            self.seg1 = Conv(32, 32, 3, **kw)
            self.seg2 = Conv(32, 32, 3, **kw)
            self.seg3 = Conv(32, nc, 1, **kw)
            self.bound = [self._add(Conv(32, 32, 3, **kw)),
                          self._add(Conv(32, nc, 1, **kw))]
            self.dist = [self._add(Conv(32, 32, 3, **kw)),
                         self._add(Conv(32, 32, 3, **kw)),
                         self._add(Conv(32, nc, 1, **kw))]
            self._add(Conv(32, 3, 1, **kw), "color")
        self.eval()
        self.to(dev)

    def forward(self, x):
        axis.refuse_space("ResUnetAV1")
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC bytes, channels_last
        c1 = x = self.stem(x)
        skips = []
        for i, block in enumerate(self.enc):
            if i:
                x = self.down[i - 1](x)
            x = checkpointed(block, x)
            skips.append(x)
        x = self.psp(x)
        for (up, comb, block), skip in zip(self.dec, skips[4::-1]):
            x = self._combine(_upsample_nearest(up(x), 2), skip, comb)
            x = checkpointed(block, x)
        x_comb = self._combine(x, c1, self.comb)
        x_psp = self.psp_out(x_comb)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        if not self.multitasking:
            return nhwc(torch.softmax(self.logits(x_psp).float(), dim=1))
        s = torch.relu(self.seg2(torch.relu(self.seg1(x_psp))))
        b = torch.relu(self.bound[0](x_psp))
        d = torch.relu(self.dist[1](torch.relu(self.dist[0](x_comb))))
        return {"seg": nhwc(torch.softmax(self.seg3(s).float(), dim=1)),
                "bound": nhwc(torch.sigmoid(self.bound[1](b).float())),
                "dist": nhwc(torch.softmax(self.dist[2](d).float(), dim=1)),
                "color": nhwc(torch.sigmoid(self.color(x_comb).float()))}


# the legacy model's stages: (input size from which the stage exists,
# features, dilations), shallow to deep
_LEGACY_STAGES = ((64, 64, (1, 3, 15, 31)), (128, 128, (1, 3, 15)),
                  (256, 256, (1, 3, 15)), (512, 512, (1,)))


class ResUnetALegacy(_ResUnetBase):
    """The input-size-adaptive single-task variant (ResUnet_a/
    model_old.py): a stage exists where the build-time img_size reaches
    its gate, so depth follows the input size. Input NHWC; returns the
    NHWC float32 softmax. `mean` is what predict_ids subtracts (config.py
    MEAN)."""

    def __init__(self, num_classes, img_size=512, mean=(82.0, 92.0, 88.0),
                 dtype=torch.float32, in_channels=3, generator=None,
                 device=None):
        super().__init__()
        dev, g = _setup(generator, device)
        self.num_classes, self.img_size = num_classes, img_size
        self.mean, self.dtype = tuple(mean), dtype
        kw = dict(dtype=dtype, generator=g)
        stages = [st for st in _LEGACY_STAGES if img_size >= st[0]]
        self._add(Conv(in_channels, 32, 1, **kw), "stem")
        self._add(ResBlockV1(32, (1, 3, 15, 31), **kw), "rb_top")
        self.enc, prev = [], 32
        for _, f, dil in stages:
            self.enc.append((self._add(Conv(prev, f, 1, stride=2, **kw)),
                             self._add(ResBlockV1(f, dil, **kw))))
            prev = f
        self.deep = (self._add(Conv(prev, 1024, 1, stride=2, **kw)),
                     self._add(ResBlockV1(1024, (1,), **kw)))
        self._add(PSPPoolingLegacy(1024, **kw), "psp")
        self.dec, prev = [], 1024
        for _, f, dil in stages[::-1]:
            up = self._add(Conv(prev, f, 1, **kw))
            comb = self._add(Conv(2 * f, f, 1, **kw))
            self.dec.append((up, comb, self._add(ResBlockV1(f, dil, **kw))))
            prev = f
        up = self._add(Conv(prev, 32, 1, **kw))
        comb = self._add(Conv(64, 32, 1, **kw))
        self.dec.append((up, comb, self._add(ResBlockV1(32, (1, 3, 15, 31),
                                                        **kw))))
        self._add(Conv(64, 32, 1, **kw), "comb")
        self._add(PSPPoolingLegacy(32, **kw), "psp_out")
        self._add(Conv(32, num_classes, 1, **kw), "logits")
        self.eval()
        self.to(dev)

    def forward(self, x):
        axis.refuse_space("ResUnetALegacy")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        c1 = x = self.stem(x)
        skips = [checkpointed(self.rb_top, x)]     # c2
        x = skips[0]
        for down, block in self.enc:
            x = checkpointed(block, down(x))
            skips.append(x)
        x = checkpointed(self.deep[1], self.deep[0](x))
        x = self.psp(x)
        for (up, comb, block), skip in zip(self.dec, skips[::-1]):
            x = self._combine(_upsample_nearest(up(x), 2), skip, comb)
            x = checkpointed(block, x)
        x = self.psp_out(self._combine(x, c1, self.comb))
        return torch.softmax(self.logits(x).float(), dim=1).permute(
            0, 2, 3, 1)

    @torch.no_grad()
    def predict_ids(self, img):
        """model_old.py:179-185: one (H, W, C) image, the config mean
        subtracted, forward in eval mode, per-pixel argmax (int64 on the
        model's device)."""
        dev = self.stem.weight.device
        x = torch.as_tensor(img, dtype=torch.float32, device=dev) - \
            torch.tensor(self.mean, dtype=torch.float32, device=dev)
        was = self.training
        self.eval()
        try:
            return self(x[None])[0].argmax(dim=-1)
        finally:
            self.train(was)
