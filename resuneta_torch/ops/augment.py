"""The reference's five augmentation variants (resuneta_tpu/ops/augment.py,
utils.py:69-95), on the device:

  0: identity, 1: rot90 counter-clockwise (np.rot90(x, 1) on the two spatial
  axes), 2: rot180, 3: flip of axis 0 (vertical), 4: flip of axis 1
  (horizontal). Not rot270.

`augment_batch` writes the batch dimension out: x is (B, H, W, ...) and
idx holds one variant per sample.
"""

import numpy as np
import torch

AUG_VARIANTS = 5


def _rot90(x):
    return torch.flip(x.transpose(1, 2), dims=(1,))


def _rot180(x):
    return torch.flip(x, dims=(1, 2))


def _flip0(x):
    return torch.flip(x, dims=(1,))


def _flip1(x):
    return torch.flip(x, dims=(2,))


_FNS = [lambda x: x, _rot90, _rot180, _flip0, _flip1]


def augment_batch(x, idx):
    """Variant idx[b] of sample x[b] for a (B, H, W, ...) batch (H == W for
    rot90). idx: (B,) ints in [0, 5), on the host or the device."""
    idx = np.asarray(torch.as_tensor(idx).cpu()).reshape(-1)
    if idx.shape[0] != x.shape[0]:
        raise ValueError(f"{idx.shape[0]} variants for {x.shape[0]} samples")
    if ((idx < 0) | (idx >= AUG_VARIANTS)).any():
        raise ValueError(f"augmentation variants must be in [0, 5): {idx}")
    out = torch.empty_like(x)
    for v in np.unique(idx):
        sel = torch.from_numpy(np.flatnonzero(idx == v)).to(x.device)
        out[sel] = _FNS[v](x[sel])
    return out

