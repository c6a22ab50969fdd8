"""The experimental ResNet50-style encoder-decoder (resuneta_tpu/models/
resnet50_unet.py; reference utils.py:135-232, identity_block + ResNet50):
five conv/pool stages with identity blocks that have no BatchNorm, a
nearest-up decoder with skip concats, a softmax head. Plain PyTorch: the
JAX module reaches no Pallas kernel. Children carry the Flax auto-names
(Conv_n, IdentityBlock_n) for convert.from_flax."""

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel import axis
from .resuneta import Conv
from .variants import _Named


class IdentityBlock(_Named):
    """utils.py:135-163: 1x1 -> f x f -> 1x1 convs (ReLU after the first
    two), the residual add, a final ReLU."""

    def __init__(self, f, filters, in_channels, dtype=torch.float32,
                 generator=None):
        super().__init__()
        F1, F2, F3 = filters
        kw = dict(dtype=dtype, generator=generator)
        self.convs = [self._add(Conv(in_channels, F1, 1, **kw)),
                      self._add(Conv(F1, F2, f, **kw)),
                      self._add(Conv(F2, F3, 1, **kw))]

    def forward(self, x):
        a, b, c = self.convs
        return torch.relu(c(torch.relu(b(torch.relu(a(x))))) + x)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResNet50UNet(_Named):
    """Input (N, H, W, in_channels) NHWC, H and W multiples of 16; returns
    the (N, H, W, num_classes) float32 softmax. Weights from `generator`
    (seeded 0 when None; glorot-uniform, zero bias) on `device` (None
    means cuda)."""

    def __init__(self, num_classes=3, dtype=torch.float32, in_channels=3,
                 generator=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, generator=g)
        self.dtype = dtype
        self._add(Conv(in_channels, 64, 7, **kw), "conv1")
        self.stages, prev = [], 64
        for f in (64, 128, 256, 512, 1024):
            conv = None if f == 64 else self._add(Conv(prev, f, 3, **kw))
            self.stages.append((conv, self._add(IdentityBlock(
                3, (f, f, f), f, **kw))))
            prev = f
        # u1..u4: each input is the previous merge (skip ++ up)
        self.ups = [self._add(Conv(cin, f, 3, **kw)) for cin, f in
                    ((1024, 512), (1024, 256), (512, 128), (256, 64))]
        self._add(Conv(128, num_classes, 1, **kw), "logits")
        self.to(dev)

    def forward(self, x):
        axis.refuse_space("ResNet50UNet")
        x = x.permute(0, 3, 1, 2).to(self.dtype)    # NHWC bytes, channels_last
        conv1 = self.conv1(x)
        skips = [conv1]
        x = self.stages[0][1](F.max_pool2d(torch.relu(conv1), 2))
        for i, (conv, ident) in enumerate(self.stages[1:]):
            c = conv(x)
            if i < 3:                                # conv2 .. conv4
                skips.append(c)
                x = ident(F.max_pool2d(torch.relu(c), 2))
            else:                                    # conv5: no pool
                x = ident(torch.relu(c))
        for up, skip in zip(self.ups, skips[::-1]):
            x = torch.cat([skip, torch.relu(up(_up2(x)))], dim=1)
        logits = self.logits(x)
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
