"""Model weights on disk: a `.pt` state_dict, or an `.npz` of flattened Flax
variables ("params/ResBlockA_0/Conv_0/kernel", ...) converted on load.

Orbax checkpoints of the JAX package are read on the JAX side and flattened
to such an .npz (tools/flax_ckpt_to_npz.py); best-checkpoint bookkeeping and
optimizer state arrive with the training slice.
"""

import numpy as np
import torch

from ..convert import from_flax


def restore_variables(path, model=None):
    """A state_dict from `path` (.pt, or .npz of Flax variables). With
    `model`, the keys and shapes are checked against it and loaded into it."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as npz:
            sd = from_flax(dict(npz), model)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if model is not None:
        model.load_state_dict(sd, strict=True)
    return sd


def save_variables(path, model):
    """Write model's state_dict (on the CPU) to a `.pt` file."""
    path = str(path)
    if not path.endswith(".pt"):
        raise ValueError(f"save_variables writes .pt files, got {path!r}")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
