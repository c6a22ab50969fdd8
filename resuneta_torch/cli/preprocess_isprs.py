"""ISPRS preprocessing CLI of the port, with the argument surface of
resuneta_tpu/cli/preprocess_isprs.py (preprocess_save_patches_ISPRS.py:
112-127: --norm_type {1,2,3}, --patch_size, --stride, --num_classes,
--data_aug) plus --device.

    python -m resuneta_torch.cli.preprocess_isprs --dataset_path <ISPRS_npy> \
        --patch_size 256 --stride 32 [--layout legacy] [--device cpu]

Reads Image_Train.npy and Reference_Train.npy (CHW), maps the reference's
colours to class ids and cuts the overlapping patch grid (extract_patches).
The default layout is the packed dataset (write_packed_dataset: uint8
images and class ids; augmentation and the label heads are made on the
device at train time, data/pipeline.py), the JAX CLI's bytes. --layout
legacy writes the reference's file-per-patch tree (train/,
labels/{seg,bound,dist,color}/patch_{i*5+j}.npy, float32, normalized,
augmented x5) with the port's augment, normalize, boundary (K6), distance
(K5) and colour ops on the device, a few patches a batch. Entry points run
on the card unless --device names another, and raise without one.
"""

import argparse
import os

import numpy as np

from ..utils.cli import str2bool

# patches through the device pipeline at a time (x5 variants each)
LEGACY_BATCH = 8


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--norm_type", help="Choose type of normalization to be used",
                        type=int, default=1, choices=[1, 2, 3])
    parser.add_argument("--patch_size", help="Choose size of patches",
                        type=int, default=256)
    parser.add_argument("--stride",
                        help="Choose stride to be using on patches extraction",
                        type=int, default=32)
    parser.add_argument("--num_classes",
                        help="Choose number of classes to convert labels to one hot"
                             " encoding", type=int, default=5)
    parser.add_argument("--data_aug",
                        help="Allow augmentation images to be added to the dataset"
                             " along with the original images",
                        type=str2bool, default=True)
    parser.add_argument("--dataset_path", type=str, default="./DATASETS/ISPRS_npy",
                        help="Directory containing Image_Train.npy/Reference_Train.npy")
    parser.add_argument("--output_path", type=str, default=None,
                        help="Output dir (default: reference naming scheme)")
    parser.add_argument("--layout", type=str, default="packed",
                        choices=["packed", "legacy"],
                        help="packed = uint8 arrays + on-device label gen at train "
                             "time; legacy = reference file-per-patch float32 tree")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (raises without a card)")
    return parser


def write_legacy_tree(folder_path, patches, patches_ref, args, device):
    """The reference's on-disk tree, every variant of LEGACY_BATCH patches
    made in one pass of make_device_pipeline on `device`."""
    from ..data import make_device_pipeline

    for sub in ("train", "labels/seg", "labels/bound", "labels/dist", "labels/color"):
        os.makedirs(os.path.join(folder_path, sub), exist_ok=True)
    n_var = 5 if args.data_aug else 1
    gen = make_device_pipeline(args.num_classes, args.norm_type,
                               multitasking=True, device=device)
    for i0 in range(0, len(patches), LEGACY_BATCH):
        idx = np.arange(i0, min(i0 + LEGACY_BATCH, len(patches)))
        out = gen({"image_u8": np.repeat(patches[idx], n_var, axis=0),
                   "label_ids": np.repeat(patches_ref[idx], n_var, axis=0),
                   "aug": np.tile(np.arange(n_var), len(idx))})
        heads = {"train": out["image"], "labels/seg": out["seg"],
                 "labels/bound": out["bound"], "labels/dist": out["dist"],
                 "labels/color": out["color"]}
        heads = {k: v.cpu().numpy() for k, v in heads.items()}
        for k, i in enumerate(idx):
            for j in range(n_var):
                name = f"patch_{i * 5 + j}.npy" if args.data_aug else f"patch_{i}.npy"
                for sub, arr in heads.items():
                    np.save(os.path.join(folder_path, sub, name), arr[k * n_var + j])


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.dataset import write_packed_dataset
    from ..data.isprs import LABEL_DICT, binarize_matrix, load_npy_image
    from ..device import resolve_device
    from ..ops.patches import extract_patches

    device = resolve_device(args.device)
    print("=" * 50)
    print("Parameters")
    print(f"patch size={args.patch_size}")
    print(f"stride={args.stride}")
    print(f"Number of classes={args.num_classes} ")
    print("=" * 50)

    root_path = args.dataset_path
    img_train = load_npy_image(os.path.join(root_path, "Image_Train.npy"))
    img_train = img_train.transpose((1, 2, 0))  # CHW -> HWC
    print("Imagem RGB")
    print(img_train.shape)

    img_train_ref = load_npy_image(os.path.join(root_path, "Reference_Train.npy"))
    img_train_ref = img_train_ref.transpose((1, 2, 0))
    print("Imagem de referencia")
    print(img_train_ref.shape)

    binary_ref = binarize_matrix(img_train_ref, LABEL_DICT)
    del img_train_ref

    patches, patches_ref = extract_patches(
        img_train, binary_ref, args.patch_size, args.stride
    )
    print(f"Number of patches: {len(patches)}")
    if args.data_aug:
        print(f"Number of patches expected: {len(patches) * 5}")

    folder_path = args.output_path or (
        f"./DATASETS/patch_size={args.patch_size}_stride={args.stride}_"
        f"norm_type={args.norm_type}_data_aug={args.data_aug}"
    )
    if args.layout == "packed":
        meta = write_packed_dataset(
            folder_path,
            patches.astype(np.uint8),
            patches_ref.astype(np.uint8),
            args.num_classes,
            norm_type=args.norm_type,
            data_aug=args.data_aug,
        )
        print(f"Packed dataset written to {folder_path}: {meta}")
    else:
        write_legacy_tree(folder_path, patches.astype(np.uint8),
                          patches_ref.astype(np.uint8), args, device)
        print(f"Legacy patch tree written to {folder_path}")


if __name__ == "__main__":
    main()
