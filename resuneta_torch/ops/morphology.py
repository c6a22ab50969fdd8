"""Morphology of the Amazon workload (resuneta_tpu/ops/morphology.py), in
place of scikit-image:

  - disk(r): skimage.morphology.disk, the pixels within L2 distance r
  - dilation_disk: grey dilation by a disk footprint (utils.py:497), the
    max over the disk's offsets; numpy arrays on the host, tensors on
    their device
  - mask_no_considered: the 3-class mask with a buffer ring around the
    deforestation (utils.py:494-503)
  - area_opening: skimage.morphology.area_opening (utils.py:529) by
    connected components a level, on the host through scipy.ndimage, as
    the reference's eval does
"""

import numpy as np
import torch
from scipy import ndimage as ndi


def disk(radius):
    """skimage.morphology.disk: pixels with L2 distance <= radius, uint8."""
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L)
    return ((X ** 2 + Y ** 2) <= radius ** 2).astype(np.uint8)


def _offsets(radius):
    fp = disk(radius)
    return [(int(i - radius), int(j - radius))
            for i, j in zip(*np.nonzero(fp)) if (i, j) != (radius, radius)]


def dilation_disk(image, radius):
    """Grey dilation of an (H, W) numpy array or tensor by disk(radius);
    pixels shifted in from outside the image hold the dtype's least value
    (-inf for a float array, as the reference's numpy branch; the least
    finite value for a float tensor, as its jnp branch)."""
    H, W = image.shape
    if isinstance(image, np.ndarray):
        low = (np.iinfo(image.dtype).min
               if np.issubdtype(image.dtype, np.integer) else -np.inf)
        out, full_like, maximum = image.copy(), np.full_like, np.maximum
    else:
        low = (torch.finfo(image.dtype).min if image.is_floating_point()
               else torch.iinfo(image.dtype).min)
        out, full_like, maximum = image.clone(), torch.full_like, \
            torch.maximum
    for di, dj in _offsets(radius):
        src = image[max(di, 0): H + min(di, 0), max(dj, 0): W + min(dj, 0)]
        shifted = full_like(image, low)
        shifted[max(-di, 0): max(-di, 0) + src.shape[0],
                max(-dj, 0): max(-dj, 0) + src.shape[1]] = src
        out = maximum(out, shifted)
    return out


def mask_no_considered(image_ref, buffer, past_ref):
    """The Amazon 3-class mask (utils.py:494-503): the ring that
    disk(buffer) adds around the current deforestation becomes class 2
    ("not considered"), and so does all past deforestation."""
    image_ref_ = np.asarray(image_ref).copy()
    im_dilate = dilation_disk(image_ref_, buffer)
    outer_buffer = im_dilate - image_ref_
    outer_buffer[outer_buffer == 1] = 2
    final_mask = image_ref_ + outer_buffer
    final_mask[np.asarray(past_ref) == 1] = 2
    return final_mask


def area_opening(image, area_threshold=64, connectivity=1):
    """Grey area opening (skimage.morphology.area_opening): each pixel is
    lowered to the highest level v whose connected component of
    {image >= v} holding it has at least `area_threshold` pixels;
    connectivity 1 is the 4-neighbourhood."""
    img = np.asarray(image)
    structure = ndi.generate_binary_structure(2, connectivity)
    out = np.zeros_like(img)
    for v in np.unique(img):
        if v <= out.min() and v <= 0:
            continue
        labels, n = ndi.label(img >= v, structure=structure)
        if n == 0:
            continue
        keep = np.bincount(labels.ravel()) >= area_threshold
        keep[0] = False
        out = np.where(keep[labels], np.maximum(out, v), out)
    return out.astype(img.dtype)
