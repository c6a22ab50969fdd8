"""Seeded weights, made on the device in one draw: every convolution kernel
glorot-uniform (the upstream Keras initialiser), biases 0, BN scale 1,
bias 0, running mean 0, running variance 1. The same seed gives the same
tensors, which load by name into the program and into the reference."""

import numpy as np
import torch

from reference.model import glorot_limit, layout


def stream_seed(seed, tag):
    """A 63-bit seed of its own for each use of the run's seed."""
    return int(np.random.SeedSequence([int(seed), sum(map(ord, tag))])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed, tag, device):
    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


def make(cfg, seed, device):
    """{name: float32 tensor on `device`}."""
    lay = layout(cfg)
    total = sum(int(np.prod(s)) for _, s, k in lay if k == "conv_w")
    flat = torch.rand(total, generator=generator(seed, "weights", device),
                      device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, kind in lay:
        if kind == "conv_w":
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].view(shape).mul_(glorot_limit(shape))
            at += n
        else:
            fill = 1.0 if kind == "ones" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out
