"""The on-device input pipeline: the raw uint8 batch -> the model's
multitask batch (resuneta_tpu/data/pipeline.py:26-77).

Only uint8 pixels and class ids cross to the card; there one of the 5
augmentation variants, normalisation, one-hot and the three derived labels
(boundary by K6, distance by K5, HSV colour) run per batch. The batch
dimension is written out: K5 and K6 each get all B*C class planes of a
batch in one call. Boundary, distance and HSV commute with the 5 variants,
so labels made after augmentation equal the reference's
augment-then-generate order.
"""

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.augment import augment_batch
from ..ops.boundary import get_boundary_label
from ..ops.colorspace import hsv_color_label, standardize_per_sample
from ..ops.distance import get_distance_label
from ..ops.normalize import normalize_rgb


def _normalize_batch(img, norm_type):
    """normalize_rgb per sample (norm_type 3 standardises each image on its
    own, as the reference's vmap does)."""
    if norm_type == 3:
        return standardize_per_sample(img)
    return normalize_rgb(img, norm_type)


def make_device_pipeline(num_classes: int, norm_type: int = 1,
                         multitasking: bool = True, color_head: bool = True,
                         device=None):
    """Returns preprocess(raw) for PackedDataset batches:
      raw: {'image_u8': (B,P,P,C) u8, 'label_ids': (B,P,P) u8, 'aug': (B,)}
      out: {'image': f32 normalised, 'seg': one-hot f32
            [, 'bound', 'dist', 'color']}, on `device` (None: the card).
    Pass it as `preprocess=` to make_train_step. A batch without
    'image_u8' (already float) passes through, moved to the device."""
    dev = resolve_device(device)

    def preprocess(raw):
        if "image_u8" not in raw:
            return {k: torch.as_tensor(v).to(dev) for k, v in raw.items()}
        img = augment_batch(torch.as_tensor(raw["image_u8"]).to(dev),
                            raw["aug"])
        ids = augment_batch(torch.as_tensor(raw["label_ids"]).to(dev),
                            raw["aug"])
        onehot = F.one_hot(ids.long(), num_classes).float()
        out = {"image": _normalize_batch(img.float(), norm_type),
               "seg": onehot}
        if multitasking:
            out["bound"] = get_boundary_label(onehot)
            out["dist"] = get_distance_label(onehot)
            if color_head:
                out["color"] = hsv_color_label(img, norm_type)
        return out

    return preprocess


def make_label_head_pipeline(device=None):
    """Boundary and distance labels for float batches that carry 'image'
    and a one-hot 'seg' (the Amazon multitask path,
    amazon_py/main_mabel_resuneta.py:152-167, made from the labels)."""
    dev = resolve_device(device)

    def preprocess(raw):
        out = {k: torch.as_tensor(v).to(dev) for k, v in raw.items()}
        if "bound" in out or "seg" not in out:
            return out
        out["bound"] = get_boundary_label(out["seg"])
        out["dist"] = get_distance_label(out["seg"])
        return out

    return preprocess
