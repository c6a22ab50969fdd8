"""Flax variables -> the port's state_dict.

Input: the Flax `{"params": ..., "batch_stats": ...}` tree as nested dicts of
numpy arrays, or the same flattened with "/"-joined keys
("params/ResBlockA_0/Conv_0/kernel", as `flatten` writes and an .npz
holds). The port's modules carry the Flax module names, so a variable maps
by its path: conv kernels HWIO -> OIHW `weight`, `bias`, BN `scale`, and
the batch_stats `mean`, `var` buffers. Any variable the mapping does not
know, and with a model given any key left unmatched on either side or of
the wrong shape, raises. A gradient tree maps the same way:
`from_flax({"params": grads})` gives the port's names and layouts.
"""

from collections.abc import Mapping

import numpy as np
import torch

_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
           ("params", "scale"): "scale", ("batch_stats", "mean"): "mean",
           ("batch_stats", "var"): "var"}


def flatten(tree, prefix=""):
    """Nested dicts -> {"a/b/c": leaf}."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(flatten(val, path + "/"))
        else:
            flat[path] = val
    return flat


def from_flax(variables, model=None):
    """Flax variables (nested or flat) -> {name: float32 tensor}. With
    `model`, also check that the keys and shapes match its state_dict."""
    flat = flatten(variables)
    sd = {}
    for key, val in flat.items():
        coll, *path, leaf = key.split("/")
        name = _LEAVES.get((coll, leaf))
        if name is None:
            raise ValueError(f"unknown Flax variable {key!r}")
        arr = np.array(val, dtype=np.float32)     # a writable copy
        if name == "weight":
            arr = arr.transpose(3, 2, 0, 1)
        sd[".".join(path + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        own = model.state_dict()
        missing = sorted(set(own) - set(sd))
        unused = sorted(set(sd) - set(own))
        if missing or unused:
            raise ValueError(f"unmatched keys: missing {missing}, "
                             f"unused {unused}")
        bad = [k for k in sd if sd[k].shape != own[k].shape]
        if bad:
            raise ValueError("shape mismatch: " + ", ".join(
                f"{k} {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
                for k in bad))
    return sd
