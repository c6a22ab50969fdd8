"""Patch extraction and whole-image reconstruction
(resuneta_tpu/ops/patches.py).

`extract_patches` is the training set's overlapping grid on the host
(preprocess_save_patches_ISPRS.py:28-48: skimage view_as_windows, here a
numpy stride-tricks view with the same row-major order);
`extract_patches_device` the same grid of a tensor, cut on its device.
`extract_patches_nonoverlap` and `reconstruct_from_patches` are the test
chop: order="row" is test_ISPRS.py's row-major chop, order="col" the
Amazon scripts' column-major variant (utils.py:402-437, 451-464). Both
take numpy arrays or torch tensors, (H, W) or (H, W, C), and return the
same kind.
"""

import numpy as np
import torch


def num_patches_grid(height, width, patch_size, stride=None):
    """(n_rows, n_cols) of the patch grid; stride defaults to patch_size."""
    stride = stride or patch_size
    return (height - patch_size) // stride + 1, \
        (width - patch_size) // stride + 1


def extract_patches(image, reference, patch_size, stride):
    """Overlapping patches of image (H, W, C) and reference (H, W), numpy:
    (N, P, P, C) and (N, P, P), N = n_rows * n_cols, row-major."""
    n_r, n_c = num_patches_grid(image.shape[0], image.shape[1], patch_size,
                                stride)
    sh0, sh1, sh2 = image.strides
    win = np.lib.stride_tricks.as_strided(
        image, shape=(n_r, n_c, patch_size, patch_size, image.shape[2]),
        strides=(sh0 * stride, sh1 * stride, sh0, sh1, sh2), writeable=False)
    rh0, rh1 = reference.strides
    win_ref = np.lib.stride_tricks.as_strided(
        reference, shape=(n_r, n_c, patch_size, patch_size),
        strides=(rh0 * stride, rh1 * stride, rh0, rh1), writeable=False)
    patches = np.ascontiguousarray(win).reshape(
        n_r * n_c, patch_size, patch_size, -1)
    patches_ref = np.ascontiguousarray(win_ref).reshape(
        n_r * n_c, patch_size, patch_size)
    return patches, patches_ref


def extract_patches_device(image, patch_size, stride):
    """The same row-major grid of an (H, W, C) tensor, cut on its device:
    (n_rows * n_cols, P, P, C)."""
    C = image.shape[2]
    grid = image.unfold(0, patch_size, stride).unfold(1, patch_size, stride)
    # (n_r, n_c, C, P, P) -> (n_r, n_c, P, P, C)
    return grid.permute(0, 1, 3, 4, 2).reshape(-1, patch_size, patch_size, C)


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
