"""Amazon preprocessing CLI of the port, with the argument surface of
resuneta_tpu/cli/preprocess_amazon.py (preprocess_save_patches_Amazon.py:
126-147: --norm_type, --patch_size, --stride, --num_classes, --data_aug,
--def_percent) plus --device.

    python -m resuneta_torch.cli.preprocess_amazon --dataset_path <Amazon_npy> \
        --patch_size 128 --stride 128 [--output_path <dir>] [--device cpu]

The two years' 7-band rasters are stacked to 14 channels; the valid-area
mask, the 3-class final mask with a buffer-2 ring (mask_no_considered), the
WCE weights from its pixel counts, the 15-tile split and, per tile, the
patches that lie in the valid footprint with >= def_percent% deforestation
(patch_tiles2). The whole-raster normalization runs on the device (the
card unless --device names another; it raises without one); the rest is
host numpy. Writes the JAX CLI's `amazon-packed-v1` layout:
{train,val}_images.npy (float32), {train,val}_labels.npy (uint8 class ids)
and manifest.json; the label heads are made at train time.
"""

import argparse
import json
import os

import numpy as np

from ..utils.cli import str2bool


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--norm_type", help="Choose type of normalization to be used",
                        type=int, default=1, choices=[1, 2, 3])
    parser.add_argument("--patch_size", help="Choose size of patches",
                        type=int, default=256)
    parser.add_argument("--stride",
                        help="Choose stride to be using on patches extraction",
                        type=int, default=32)
    parser.add_argument("--num_classes", help="Number of classes", type=int, default=3)
    parser.add_argument("--data_aug", type=str2bool, default=True)
    parser.add_argument("--def_percent",
                        help="Choose minimum percentage of Deforastation",
                        type=int, default=5)
    parser.add_argument("--dataset_path", type=str, default="./DATASETS/Amazon_npy")
    parser.add_argument("--output_path", type=str, default=None)
    parser.add_argument("--image_t1", type=str,
                        default="clipped_raster_004_66_2018.npy")
    parser.add_argument("--image_t2", type=str,
                        default="clipped_raster_004_66_2019.npy")
    parser.add_argument("--mask_ref", type=str, default="mask_ref.npy")
    parser.add_argument("--reference", type=str,
                        default="labels/binary_clipped_2019.npy")
    parser.add_argument("--past_reference", type=str, nargs="*",
                        default=["labels/binary_clipped_2013_2018.npy",
                                 "labels/binary_clipped_1988_2012.npy"])
    parser.add_argument("--buffer", type=int, default=2)
    parser.add_argument("--train_tiles", type=int, nargs="*", default=[5, 8, 10, 13])
    parser.add_argument("--val_tiles", type=int, nargs="*", default=[7, 12])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (raises without a card)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.amazon import (class_weights_from_counts, make_tile_mask,
                               patch_tiles2)
    from ..data.isprs import load_npy_image
    from ..device import resolve_device
    from ..ops.morphology import mask_no_considered
    from .train_amazon import load_years, normalize_scene, sum_rasters

    device = resolve_device(args.device)
    print("=" * 50)
    print("Parameters")
    print(f"patch size={args.patch_size}")
    print(f"stride={args.stride}")
    print(f"Number of classes={args.num_classes} ")
    print(f"Norm type: {args.norm_type}")
    print(f"Using data augmentation? {args.data_aug}")
    print("=" * 50)

    root = args.dataset_path
    image_array = load_years(root, args.image_t1, args.image_t2)
    print(f"Input image shape: {image_array.shape}")

    mask_valid = load_npy_image(os.path.join(root, args.mask_ref))
    image_ref = load_npy_image(os.path.join(root, args.reference))
    past = sum_rasters(root, args.past_reference)

    H = min(image_array.shape[0], image_ref.shape[0], mask_valid.shape[0])
    W = min(image_array.shape[1], image_ref.shape[1], mask_valid.shape[1])
    image_array = image_array[:H, :W]
    mask_valid = mask_valid[:H, :W]
    image_ref = image_ref[:H, :W]
    past = past[:H, :W]

    final_mask = mask_no_considered(image_ref, args.buffer, past)
    unique, counts = np.unique(final_mask, return_counts=True)
    print(f"Pixels of final mask: {dict(zip(unique.tolist(), counts.tolist()))}")
    weights = class_weights_from_counts(final_mask)
    print(f"WCE weights from pixel counts: {weights}")

    image_array = normalize_scene(image_array, args.norm_type, device)
    mask_tiles = make_tile_mask(H, W)

    out_root = args.output_path or (
        f"./DATASETS/amazon_patch_size={args.patch_size}_stride={args.stride}_"
        f"norm_type={args.norm_type}_data_aug={args.data_aug}")

    manifest = {
        "format": "amazon-packed-v1",
        "patch_size": args.patch_size,
        "channels": int(image_array.shape[-1]),
        "num_classes": args.num_classes,
        "norm_type": args.norm_type,
        "data_aug": bool(args.data_aug),
        "def_percent": args.def_percent,
        "class_weights": weights,
        "splits": {},
    }
    os.makedirs(out_root, exist_ok=True)
    for split, tiles in (("train", args.train_tiles), ("val", args.val_tiles)):
        p, r = patch_tiles2(tiles, mask_tiles, image_array, final_mask, mask_valid,
                            args.patch_size, args.stride, args.def_percent)
        np.save(os.path.join(out_root, f"{split}_images.npy"),
                p.astype(np.float32))
        np.save(os.path.join(out_root, f"{split}_labels.npy"), r.astype(np.uint8))
        manifest["splits"][split] = {"tiles": tiles, "num_patches": int(len(p))}
        print(f"{split}: {len(p)} patches from tiles {tiles}")
    with open(os.path.join(out_root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"Amazon dataset written to {out_root}")


if __name__ == "__main__":
    main()
