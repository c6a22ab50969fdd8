"""Small helpers of the reference's utils.py (resuneta_tpu/data/
legacy_utils.py), numpy on the host; none sits on a hot path."""

import numpy as np


def extract_patches_mask_indices(input_image, patch_size, stride):
    """utils.py:59-67: sliding windows over the flat pixel-index grid:
    (N, P, P) arrays of flattened indices, row-major windows."""
    h, w = input_image.shape[:2]
    image_indices = np.arange(h * w).reshape(h, w)
    n_r = (h - patch_size) // stride + 1
    n_c = (w - patch_size) // stride + 1
    s0, s1 = image_indices.strides
    win = np.lib.stride_tricks.as_strided(
        image_indices,
        shape=(n_r, n_c, patch_size, patch_size),
        strides=(s0 * stride, s1 * stride, s0, s1),
        writeable=False,
    )
    return np.ascontiguousarray(win).reshape(n_r * n_c, patch_size, patch_size)


def get_patches_batch(image, rows, cols, radio, batch):
    """utils.py:255-261: (2*radio+1)^2 patches centred on the given (row,
    col) pixels."""
    temp = []
    for i in range(batch):
        temp.append(image[rows[i] - radio: rows[i] + radio + 1,
                          cols[i] - radio: cols[i] + radio + 1, :])
    return np.asarray(temp)


def test_model(test_x, test_y, apply_fn):
    """utils.py:235-240: per-sample classification eval: (predicted class,
    true class, class-1 probabilities)."""
    result = np.asarray(apply_fn(test_x))
    result1 = result[:, 1]
    predicted_class = np.argmax(result, axis=1)
    return predicted_class, test_y, result1
