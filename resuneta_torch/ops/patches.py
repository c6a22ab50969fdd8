"""Non-overlapping patch chop and whole-image reconstruction
(resuneta_tpu/ops/patches.py:56-90).

order="row" is test_ISPRS.py's row-major chop; order="col" is the Amazon
scripts' column-major variant (utils.py:402-437, 451-464). Both take numpy
arrays or torch tensors, (H, W) or (H, W, C), and return the same kind.
"""

import numpy as np
import torch


def _permute(a, axes):
    return a.permute(axes) if isinstance(a, torch.Tensor) else a.transpose(axes)


def extract_patches_nonoverlap(image, patch_size, order="row"):
    """(H, W[, C]) -> (n_h*n_w, P, P[, C]), truncating any remainder."""
    H, W = image.shape[:2]
    n_h, n_w = H // patch_size, W // patch_size
    img = image[: n_h * patch_size, : n_w * patch_size]
    trail = tuple(img.shape[2:])
    grid = img.reshape((n_h, patch_size, n_w, patch_size) + trail)
    axes = (2, 0, 1, 3) if order == "col" else (0, 2, 1, 3)
    out = _permute(grid, axes + tuple(range(4, grid.ndim)))
    out = out.reshape((n_h * n_w, patch_size, patch_size) + trail)
    return out if isinstance(out, torch.Tensor) else np.ascontiguousarray(out)


def reconstruct_from_patches(patches, height, width, order="row"):
    """(N, P, P[, C]) -> (n_h*P, n_w*P[, C]), the truncated grid."""
    P = patches.shape[1]
    n_h, n_w = height // P, width // P
    rest = tuple(patches.shape[1:])
    if order == "row":
        grid = patches.reshape((n_h, n_w) + rest)
    else:
        grid = _permute(patches.reshape((n_w, n_h) + rest),
                        (1, 0) + tuple(range(2, patches.ndim + 1)))
    out = _permute(grid, (0, 2, 1, 3) + tuple(range(4, grid.ndim)))
    return out.reshape((n_h * P, n_w * P) + rest[2:])
