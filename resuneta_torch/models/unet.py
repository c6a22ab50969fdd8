"""UNet baseline (resuneta_tpu/models/unet.py) — the reference's
`--resunet_a False` path (utils.py:98-133): 4 maxpool downs with a single
3x3 relu conv per level (32..512 filters), nearest-up decoder with 3x3 relu
conv + skip concat, final 1x1 conv + softmax head named 'seg'.

A plain PyTorch module, no kernel of its own. Its convs are named Conv_0 ..
Conv_9 in the order of Flax's compact naming (c1..c5, u1..u4, the logits),
so convert.from_flax carries the JAX UNet's weights across unchanged.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel import axis
from .resuneta import Conv


class UNet(nn.Module):
    """Input (N, H, W, in_channels) NHWC, H and W multiples of 16; returns
    the (N, H, W, num_classes) float32 softmax. Weights are drawn on the CPU
    from `generator` (a fresh generator seeded 0 when None; glorot-uniform
    kernels, zero bias), then moved to `device` (None means cuda, see
    device.resolve_device). Params are float32, the compute dtype is
    `dtype`."""

    def __init__(self, num_classes, base_filters=32, dtype=torch.float32,
                 in_channels=3, generator=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, generator=g)
        f1 = base_filters
        self.dtype = dtype
        enc = [f1, f1 * 2, f1 * 4, f1 * 8, f1 * 16]
        prev = in_channels
        for i, f in enumerate(enc):                     # c1 .. c5
            self.add_module(f"Conv_{i}", Conv(prev, f, 3, **kw))
            prev = f
        for i, f in enumerate(enc[3::-1]):              # u1 .. u4
            self.add_module(f"Conv_{5 + i}", Conv(prev, f, 3, **kw))
            prev = 2 * f                                # the skip concat
        self.Conv_9 = Conv(prev, num_classes, 1, **kw)
        self.to(dev)

    def forward(self, x):
        """Under a live space axis (parallel/axis.py) x is a band of rows,
        H/16 whole rows at the deepest level: the 3x3 convs read halos
        (Conv), the pools and upsamples stay local."""
        axis.check_band(x.shape[1], 16, "UNet")
        x = x.permute(0, 3, 1, 2).to(self.dtype)   # NHWC bytes, channels_last
        skips = []
        for i in range(5):
            if i:
                x = F.max_pool2d(x, 2)
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
            skips.append(x)
        for i, skip in enumerate(skips[3::-1]):
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            x = torch.cat([skip, torch.relu(getattr(self, f"Conv_{5 + i}")(up))],
                          dim=1)
        logits = self.Conv_9(x)
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
