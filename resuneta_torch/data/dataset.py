"""Datasets of the port (resuneta_tpu/data/dataset.py), numpy batches on
the host; the train step moves them to its device (train/steps.py `_on`,
or the device pipeline, data/pipeline.py).

The reference's input pipeline is a directory of one .npy file per patch per label
head, loaded serially with np.load on the training critical path
(train_ISPRS.py:122-146; ~5.5 MB of float32 per multitask sample). The
replacement is a PACKED dataset: one uint8 image array + one uint8 class-id array,
memory-mapped, with augmentation and all four label heads derived on the device
inside the train step (data/pipeline.py). A multitask sample costs ~260 KB of host
I/O instead of ~5.5 MB, and the disk format is independent of norm_type /
augmentation / label heads. The format is the JAX package's, byte for byte, so
either package reads what the other wrote.

LegacyPatchDataset still reads the reference's file-per-patch tree (the train CLI
auto-detects the layout), with a thread-pool prefetcher instead of serial np.load.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MANIFEST = "manifest.json"
AUG_FACTOR = 5  # the reference's exactly-5 augmentation variants


def write_packed_dataset(out_dir, images_u8, label_ids_u8, num_classes,
                         norm_type=1, data_aug=True, extra_meta=None):
    """Write the packed format: images.npy (N,P,P,C) u8, labels.npy (N,P,P) u8."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "images.npy"), np.ascontiguousarray(images_u8))
    np.save(os.path.join(out_dir, "labels.npy"), np.ascontiguousarray(label_ids_u8))
    meta = {
        "format": "packed-v1",
        "num_patches": int(images_u8.shape[0]),
        "patch_size": int(images_u8.shape[1]),
        "channels": int(images_u8.shape[3]),
        "num_classes": int(num_classes),
        "norm_type": int(norm_type),
        "data_aug": bool(data_aug),
    }
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def is_packed(path):
    return os.path.exists(os.path.join(path, MANIFEST))


class PackedDataset:
    """Memory-mapped packed patches. Logical length = N * 5 when data_aug (sample k
    maps to patch k//5, augmentation variant k%5 — same ids as the reference's
    patch_{i*5+j}.npy naming, preprocess_save_patches_ISPRS.py:203-228)."""

    def __init__(self, root, indices=None):
        with open(os.path.join(root, MANIFEST)) as f:
            self.meta = json.load(f)
        self.images = np.load(os.path.join(root, "images.npy"), mmap_mode="r")
        self.labels = np.load(os.path.join(root, "labels.npy"), mmap_mode="r")
        self.aug = self.meta.get("data_aug", True)
        n_logical = self.meta["num_patches"] * (AUG_FACTOR if self.aug else 1)
        self.indices = np.arange(n_logical) if indices is None else np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def subset(self, idx):
        return PackedDataset.__wrap__(self, self.indices[idx])

    @classmethod
    def __wrap__(cls, parent, indices):
        obj = cls.__new__(cls)
        obj.meta = parent.meta
        obj.images = parent.images
        obj.labels = parent.labels
        obj.aug = parent.aug
        obj.indices = indices
        return obj

    def get_batch(self, positions):
        """positions: indices into this dataset view. Returns the RAW device-pipeline
        batch: uint8 images, uint8 label ids, int32 augmentation variants.
        Batch assembly uses the native parallel row gather when available."""
        from . import native_loader

        sample_ids = self.indices[positions]
        if self.aug:
            patch_ids = sample_ids // AUG_FACTOR
            variants = (sample_ids % AUG_FACTOR).astype(np.int32)
        else:
            patch_ids = sample_ids
            variants = np.zeros(len(sample_ids), np.int32)
        return {
            "image_u8": native_loader.gather_rows(self.images, patch_ids),
            "label_ids": native_loader.gather_rows(self.labels, patch_ids),
            "aug": variants,
        }


def _resize_bilinear(img, out_h, out_w):
    """cv2.resize-compatible bilinear resize (align half-pixel centers), HW[C]."""
    img = np.asarray(img, np.float32)
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h, dtype=np.float64) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w, dtype=np.float64) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys), 0, in_h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, in_w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    if img.ndim == 3:
        wy = wy[:, None, None]
        wx = wx[None, :, None]
    else:
        wy = wy[:, None]
        wx = wx[None, :]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize_nearest(arr, out_h, out_w):
    """cv2 INTER_NEAREST-compatible resize for label maps, HW[C]."""
    arr = np.asarray(arr)
    in_h, in_w = arr.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return arr
    ys = np.minimum((np.arange(out_h) * in_h / out_h).astype(np.int64), in_h - 1)
    xs = np.minimum((np.arange(out_w) * in_w / out_w).astype(np.int64), in_w - 1)
    return arr[ys][:, xs]


def _load_any(path):
    """Read .npy directly; decode anything else as an image (the reference's
    DataGenerator uses cv2.imread, ResUnet_a/utils.py:49-51 — PIL gives the
    same pixel array for PNG/JPEG without requiring cv2 at import time)."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image
    return np.asarray(Image.open(path))


class DirectoryPairDataset:
    """Directory-paired image/label loader — the DataGenerator_wqw equivalent
    (ResUnet_a/utils.py:20-66): matching filenames under image_dir/label_dir
    (.npy or decodable images), resize to config (H, W) (ResUnet_a/utils.py:50-52:
    bilinear for images, nearest for labels), optional mean subtraction, labels
    converted to one-hot. Multi-channel label images use channel 0
    (ResUnet_a/utils.py:53)."""

    def __init__(self, image_dir, label_dir, num_classes, mean=None, workers=8,
                 target_size=None):
        names = sorted(os.listdir(image_dir))
        self.image_paths = [os.path.join(image_dir, n) for n in names]
        self.label_paths = [os.path.join(label_dir, n) for n in names]
        self.num_classes = num_classes
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.target_size = target_size  # (H, W) or None
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.image_paths)

    def subset(self, idx):
        obj = DirectoryPairDataset.__new__(DirectoryPairDataset)
        obj.image_paths = [self.image_paths[i] for i in idx]
        obj.label_paths = [self.label_paths[i] for i in idx]
        obj.num_classes = self.num_classes
        obj.mean = self.mean
        obj.target_size = self.target_size
        obj.pool = self.pool
        return obj

    def get_batch(self, positions):
        imgs = list(self.pool.map(
            _load_any, [self.image_paths[i] for i in positions]))
        lbls = list(self.pool.map(
            _load_any, [self.label_paths[i] for i in positions]))
        lbls = [lb[:, :, 0] if lb.ndim == 3 else lb for lb in lbls]
        if self.target_size is not None:
            h, w = self.target_size
            imgs = [_resize_bilinear(im, h, w) for im in imgs]
            lbls = [_resize_nearest(lb, h, w) for lb in lbls]
        imgs = np.stack(imgs).astype(np.float32)
        lbls = np.stack(lbls)
        if self.mean is not None:
            imgs = imgs - self.mean
        onehot = np.eye(self.num_classes, dtype=np.float32)[lbls.astype(np.int64)]
        return {"image": imgs, "seg": onehot}


class ArrayDataset:
    """In-memory batch source over a dict of equally-sized leading-axis arrays
    (the Keras model.fit(x, y) analog used by the Amazon scripts)."""

    def __init__(self, arrays):
        self.arrays = arrays
        n = {len(v) for v in arrays.values()}
        assert len(n) == 1, "all arrays must share the leading dimension"
        self._len = n.pop()

    def __len__(self):
        return self._len

    def subset(self, idx):
        return ArrayDataset({k: v[idx] for k, v in self.arrays.items()})

    def get_batch(self, positions):
        return {k: np.ascontiguousarray(v[positions]) for k, v in self.arrays.items()}


class LegacyPatchDataset:
    """The reference's file-per-patch directory tree: train/ labels/{seg,bound,dist,
    color}/ with patch_{k}.npy files (train_ISPRS.py:354-374). Batches are float32
    and already normalized / label-generated on disk; the device pipeline is a
    pass-through. A thread pool overlaps the np.load calls."""

    def __init__(self, root, multitasking=True, paths=None, workers=8):
        self.multitasking = multitasking
        self._shapes = {}
        if paths is None:
            train_dir = os.path.join(root, "train")
            names = sorted(os.listdir(train_dir))
            heads = ["seg", "bound", "dist", "color"] if multitasking else ["seg"]
            paths = {
                "image": [os.path.join(train_dir, n) for n in names],
            }
            for h in heads:
                paths[h] = [os.path.join(root, "labels", h, n) for n in names]
        self.paths = paths
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.paths["image"])

    def subset(self, idx):
        sub = {k: [v[i] for i in idx] for k, v in self.paths.items()}
        return LegacyPatchDataset(None, self.multitasking, paths=sub)

    def get_batch(self, positions):
        from . import native_loader

        out = {}
        for key, plist in self.paths.items():
            files = [plist[i] for i in positions]
            if key not in self._shapes:
                probe = np.load(files[0])
                self._shapes[key] = (probe.shape, probe.dtype)
            shape, dtype = self._shapes[key]
            batch = native_loader.load_npy_batch(files, shape, dtype)
            if batch is None:  # fallback: Python thread pool
                batch = np.stack(list(self.pool.map(np.load, files)))
            out[key] = batch.astype(np.float32, copy=False)
        return out
