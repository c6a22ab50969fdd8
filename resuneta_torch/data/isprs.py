"""ISPRS Potsdam label colours and RGB <-> class-id conversion
(resuneta_tpu/data/isprs.py).

LABEL_DICT matches preprocess_save_patches_ISPRS.py:155-156 and
test_ISPRS.py:262-263. Unknown colours map to 255 (the reference
initializes with uint8 -1).
"""

import numpy as np

LABEL_DICT = {
    (255, 255, 255): 0,
    (0, 255, 0): 1,
    (0, 255, 255): 2,
    (0, 0, 255): 3,
    (255, 255, 0): 4,
}


def _rgb(key):
    """A colour key as a tuple; the reference's "(r, g, b)" strings too."""
    if isinstance(key, str):
        return tuple(int(v) for v in key.strip("()").split(","))
    return key


def binarize_matrix(img_ref_rgb, label_dict=None):
    """(H, W, 3) uint8 RGB reference -> (H, W) uint8 class ids, through a
    24-bit lookup table."""
    label_dict = label_dict or LABEL_DICT
    img = np.asarray(img_ref_rgb).astype(np.uint32)
    keys = img[..., 0] << 16 | img[..., 1] << 8 | img[..., 2]
    lut = np.full(1 << 24, 255, np.uint8)
    for key, cid in label_dict.items():
        r, g, b = _rgb(key)
        lut[(r << 16) | (g << 8) | b] = cid
    return lut[keys]


def class_ids_to_rgb(ids, label_dict=None):
    """(H, W) class ids -> (H, W, 3) uint8 RGB (test_ISPRS.py:89-99)."""
    label_dict = label_dict or LABEL_DICT
    palette = np.zeros((256, 3), np.uint8)
    for key, cid in label_dict.items():
        palette[cid] = _rgb(key)
    return palette[np.asarray(ids).astype(np.int64)]


def load_npy_image(path):
    """utils.py:38-42."""
    return np.load(path)
