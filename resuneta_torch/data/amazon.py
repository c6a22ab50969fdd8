"""Amazon deforestation workload helpers (resuneta_tpu/data/amazon.py).

The reference splits two co-registered 7-band rasters (concatenated to 14
channels, amazon_py/main.py:11-19) into a 5x3 = 15-tile grid with
hand-picked train/val/test tile ids (main.py:43-64,
preprocess_save_patches_Amazon.py:239-264), extracts patches per tile, and
keeps only patches with >= percent% deforestation (utils.py:344-400,
utils2.py:115-139).

Host-side numpy, the offline dataset build; the patches and labels are the
JAX package's, bit for bit.
"""

import numpy as np

from ..ops.patches import extract_patches


def data_augmentation(image, labels):
    """The reference's exactly-5 augmentation variants (utils.py:69-95), host-side.
    image: (H, W, C); labels: (H, W). Returns float copies stacked on axis 0."""
    aug_imgs = np.stack([
        image, np.rot90(image, 1), np.rot90(image, 2),
        np.flip(image, 0), np.flip(image, 1),
    ])
    aug_lbs = np.stack([
        labels, np.rot90(labels, 1), np.rot90(labels, 2),
        np.flip(labels, 0), np.flip(labels, 1),
    ])
    return aug_imgs, aug_lbs


def make_tile_mask(height, width, rows=5, cols=3):
    """15-tile id mask (ids 1..rows*cols, row-major), the generalized version of the
    hardcoded concatenations in main.py:43-49."""
    tile_h, tile_w = height // rows, width // cols
    mask = np.zeros((tile_h * rows, tile_w * cols), np.int32)
    tid = 1
    for r in range(rows):
        for c in range(cols):
            mask[r * tile_h:(r + 1) * tile_h, c * tile_w:(c + 1) * tile_w] = tid
            tid += 1
    return mask


def tile_bbox(mask_tiles, tile_id):
    rows, cols = np.where(mask_tiles == tile_id)
    return rows.min(), cols.min(), rows.max(), cols.max()


def patch_tiles(tiles, mask_tiles, image_array, image_ref, patch_size, stride):
    """utils.py:344-380: per-tile bbox crop -> overlapping patch extraction."""
    patches_out, label_out = [], []
    for tid in tiles:
        x1, y1, x2, y2 = tile_bbox(mask_tiles, tid)
        tile_img = image_array[x1:x2 + 1, y1:y2 + 1, :]
        tile_ref = image_ref[x1:x2 + 1, y1:y2 + 1]
        p, r = extract_patches(tile_img, tile_ref, patch_size, stride)
        patches_out.append(p)
        label_out.append(r)
    return np.concatenate(patches_out), np.concatenate(label_out)


def patch_tiles2(tiles, mask_tiles, image_array, image_ref, mask_valid,
                 patch_size, stride, percent):
    """utils2.py:115-139 (repaired): per-tile extraction keeping only fully-valid
    patches (mask_valid == -1 everywhere, the satellite footprint convention) with
    >= percent% deforestation."""
    patches_out, label_out = [], []
    for tid in tiles:
        x1, y1, x2, y2 = tile_bbox(mask_tiles, tid)
        p, r = extract_patches(
            image_array[x1:x2 + 1, y1:y2 + 1, :],
            image_ref[x1:x2 + 1, y1:y2 + 1], patch_size, stride)
        m, _ = extract_patches(
            mask_valid[x1:x2 + 1, y1:y2 + 1, None].astype(np.float32),
            image_ref[x1:x2 + 1, y1:y2 + 1], patch_size, stride)
        valid = np.all(m[..., 0] == -1, axis=(1, 2))
        frac = np.mean(r == 1, axis=(1, 2))
        keep = valid & (frac >= percent / 100.0)
        patches_out.append(p[keep])
        label_out.append(r[keep])
    return np.concatenate(patches_out), np.concatenate(label_out)


def bal_aug_patches(percent, patch_size, patches_img, patches_ref):
    """utils.py:383-400: keep patches with >= percent% class-1 pixels, augment x5."""
    imgs, lbls = [], []
    threshold = int((patch_size ** 2) * (percent / 100.0))
    for i in range(len(patches_img)):
        if np.sum(patches_ref[i] == 1) >= threshold:
            a_img, a_lbl = data_augmentation(patches_img[i], patches_ref[i])
            imgs.append(a_img)
            lbls.append(a_lbl)
    if not imgs:
        raise ValueError(
            f"bal_aug_patches: no patch reached {percent}% class-1 pixels — "
            "lower --percent or check the tile selection")
    patches_bal = np.concatenate(imgs).astype(np.float32)
    labels_bal = np.concatenate(lbls).astype(np.float32)
    return patches_bal, labels_bal


def _strided_starts(extent, patch_size, stride):
    """Start offsets of FULL windows visited by the reference's while loops
    (utils2.py:14-45: partial windows at the border are skipped by the implicit
    shape check)."""
    return range(0, max(extent - patch_size + 1, 0), stride)


def extract_patches_right_region(img_train, img_train_ref, img_mask_ref,
                                 patch_size, stride, percent=5):
    """utils2.py:5-46 (and utils.py:302-342): column-major strided walk keeping
    full patches that (a) lie entirely in the valid footprint (mask == -1),
    (b) contain class 1, and (c) have >= percent% class-1 among {0,1} pixels."""
    H, W = img_train_ref.shape[:2]
    patches_train, patches_ref = [], []
    for j in _strided_starts(W, patch_size, stride):       # columns outer
        for i in _strided_starts(H, patch_size, stride):   # rows inner
            ref = img_train_ref[i:i + patch_size, j:j + patch_size]
            msk = img_mask_ref[i:i + patch_size, j:j + patch_size]
            n1 = int(np.sum(ref == 1))
            if n1 == 0 or not np.all(msk == -1):
                continue
            n0 = int(np.sum(ref == 0))
            if n1 / max(n0 + n1, 1) >= percent / 100.0:
                patches_train.append(img_train[i:i + patch_size, j:j + patch_size])
                patches_ref.append(ref)
    return patches_train, patches_ref


def extract_patches_right_region_prediction(img_train, img_train_ref,
                                            mask_amazon_ts, final_mask,
                                            patch_size, stride):
    """utils2.py:48-83: keep every full patch whose reference contains no -1."""
    H, W = img_train_ref.shape[:2]
    patches_train, patches_ref = [], []
    for j in _strided_starts(W, patch_size, stride):
        for i in _strided_starts(H, patch_size, stride):
            ref = img_train_ref[i:i + patch_size, j:j + patch_size]
            if np.all(ref != -1):
                patches_train.append(img_train[i:i + patch_size, j:j + patch_size])
                patches_ref.append(ref)
    return patches_train, patches_ref, [], []


def patches_with_out_overlap(img, stride, img_type, img_ref=None):
    """utils2.py:255-288: column-major non-overlap chop skipping patches whose
    reference contains -1 (img_type 1 = 2-D reference, 2 = multi-channel image)."""
    patch_size = stride
    h, w = img.shape[:2]
    out = []
    for i in range(w // stride):
        for j in range(h // stride):
            sl = (slice(stride * j, stride * (j + 1)),
                  slice(stride * i, stride * (i + 1)))
            ref = (img_ref if img_ref is not None else img)[sl[0], sl[1]]
            if np.all(ref != -1):
                out.append(img[sl] if img_type == 1 else img[sl[0], sl[1], :])
    return np.asarray(out)


def patch_tiles_prediction(tiles, mask_amazon, image_array, image_ref,
                           img_mask_ref, patch_size, stride):
    """utils2.py:85-112 (repaired: the reference indexes mask_amazon==1 instead of
    the tile id — a bug; we use the tile id): per-tile non-overlapping valid
    patches for prediction."""
    patches_out, label_out = [], []
    for tid in tiles:
        x1, y1, x2, y2 = tile_bbox(mask_amazon, tid)
        tile_img = image_array[x1:x2 + 1, y1:y2 + 1, :]
        tile_ref = image_ref[x1:x2 + 1, y1:y2 + 1]
        patches_out.append(patches_with_out_overlap(tile_img, stride, 2, tile_ref))
        label_out.append(patches_with_out_overlap(tile_ref, stride, 1, tile_ref))
    return np.concatenate(patches_out), np.concatenate(label_out)


def patch_tiles3(tiles, mask_amazon, image_ref):
    """utils2.py:141-188: per-tile deforestation share (% of total deforestation),
    returned as {tile_id: percent} (the reference prints and returns empties)."""
    unique, counts = np.unique(image_ref, return_counts=True)
    d = dict(zip(unique.tolist(), counts.tolist()))
    total_def = max(d.get(1, 0), 1)
    out = {}
    for tid in tiles:
        x1, y1, x2, y2 = tile_bbox(mask_amazon, tid)
        tile_ref = image_ref[x1:x2 + 1, y1:y2 + 1]
        out[tid] = round(100.0 * np.sum(tile_ref == 1) / total_def, 3)
    return out


def bal_aug_patches2(percent, patch_size, patches_img, patches_ref):
    """utils2.py:190-218: augment ALL patches x5 (no percent filter)."""
    imgs, lbls = [], []
    for i in range(len(patches_img)):
        a_img, a_lbl = data_augmentation(patches_img[i], patches_ref[i])
        imgs.append(a_img)
        lbls.append(a_lbl)
    return (np.concatenate(imgs).astype(np.float32),
            np.concatenate(lbls).astype(np.float32))


def bal_aug_patches3(percent, patch_size, patches_img, patches_ref):
    """utils2.py:220-244: percent filter + patch must contain no -1 pixels."""
    imgs, lbls = [], []
    threshold = int((patch_size ** 2) * (percent / 100.0))
    for i in range(len(patches_img)):
        ref = patches_ref[i]
        if np.sum(ref == 1) >= threshold and np.all(ref != -1):
            a_img, a_lbl = data_augmentation(patches_img[i], ref)
            imgs.append(a_img)
            lbls.append(a_lbl)
    return (np.concatenate(imgs).astype(np.float32),
            np.concatenate(lbls).astype(np.float32))


def class_weights_from_counts(final_mask):
    """WCE weights from pixel counts (preprocess_save_patches_Amazon.py:229-232):
    weight_c = total / count_c for classes 0 and 1; class 2 (not considered) -> 0."""
    unique, counts = np.unique(final_mask, return_counts=True)
    d = dict(zip(unique.tolist(), counts.tolist()))
    total = d.get(0, 0) + d.get(1, 0) + d.get(2, 0)
    return [total / max(d.get(0, 1), 1), total / max(d.get(1, 1), 1), 0.0]
