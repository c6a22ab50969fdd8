"""ISPRS inference/eval CLI of the port, with the argument surface of
resuneta_tpu/cli/test_isprs.py (test_ISPRS.py:215-236) plus --device.

    python -m resuneta_torch.cli.test_isprs --model_path weights.pt \
        --dataset_path <dir with Image_Test.npy, Reference_Test.npy> \
        --use_multitasking -ps 256

Flow (test_ISPRS.py:238-415): load the CHW test image and RGB reference,
normalize (norm_type 3 fits the scaler on the image itself), chop into
non-overlapping patches, predict in batches, print the confusion matrix,
accuracy, F1, recall, precision, per-class IoU and mIoU, and save the
reconstructed class map as pred_seg_reconstructed.jpeg. --model_path is a
.pt state_dict, an .npz of flattened Flax variables, or a training
checkpoint directory of the port's train CLI (best_model.ckpt).
--resunet_a False evaluates the UNet baseline.
"""

import argparse
import os

import numpy as np

from ..utils.cli import str2bool

MULTITASK_VIZ_NOTE = (
    "per-class/per-task prediction grids and the HSV render are not written: "
    "they need the boundary (Canny) and distance (JFA) label kernels, which "
    "arrive with the training slice")


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--use_multitasking", help="Choose resunet-a model or not",
                        action="store_true")
    parser.add_argument("--model_path", help="Model weights (.pt, Flax .npz "
                        "or a training checkpoint directory)",
                        type=str, required=True)
    parser.add_argument("--dataset_path", help="Dataset directory path",
                        type=str, required=True)
    parser.add_argument("-ps", "--patch_size",
                        help="Size of Patches extracted from image and reference",
                        type=int, default=256)
    parser.add_argument("--norm_type", choices=[1, 2, 3],
                        help="Types of normalization. Be sure to select the same type"
                             " used in your training. 1 --> [0,1]; 2 --> [-1,1]; "
                             "3 --> StandardScaler() from scikit",
                        type=int, default=1)
    parser.add_argument("--num_classes", help="Number of classes", type=int, default=5)
    parser.add_argument("--output_path", help="Path to where save predictions",
                        type=str, default="results/preds_run")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="Inference batch size (reference used 1)")
    parser.add_argument("--resunet_a", default=True, type=str2bool,
                        help="Model family of the checkpoint")
    parser.add_argument("--max_viz_patches", type=int, default=8,
                        help="Cap on per-patch visualization grids")
    parser.add_argument("--overlap_stride", type=int, default=None,
                        help="Overlap-averaged reconstruction: window stride "
                             "< patch_size averages softmax probabilities over "
                             "all windows covering a pixel")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (raises without a card)")
    return parser


def _save_image(path, rgb):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.imsave(path, rgb)
    except ImportError:
        from PIL import Image
        Image.fromarray(rgb).save(path)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..data.isprs import (LABEL_DICT, binarize_matrix, class_ids_to_rgb,
                              load_npy_image)
    from ..device import resolve_device
    from ..infer.sliding import (make_apply_fn, predict_patches,
                                 predict_scene_overlap)
    from ..metrics import compute_metrics, confusion_matrix, iou_per_class
    from ..models import ResUnetA, UNet
    from ..ops.normalize import normalization, normalize_rgb
    from ..ops.patches import extract_patches_nonoverlap, reconstruct_from_patches
    from ..train.checkpoint import restore_model, restore_variables

    device = resolve_device(args.device)
    root_path = args.dataset_path
    img_test = load_npy_image(
        os.path.join(root_path, "Image_Test.npy")).astype(np.float32)
    if args.norm_type == 3:
        # reference quirk: the whole-image scaler is fit on the CHW array
        img_test_normalized = normalization(torch.from_numpy(img_test), 1)
    else:
        img_test_normalized = normalize_rgb(torch.from_numpy(img_test),
                                            args.norm_type)
    img_test_normalized = img_test_normalized.numpy().transpose((1, 2, 0))
    print(img_test_normalized.shape)

    img_test_ref = load_npy_image(
        os.path.join(root_path, "Reference_Test.npy")).transpose((1, 2, 0))
    print(img_test_ref.shape)
    binary_ref = binarize_matrix(img_test_ref, LABEL_DICT)

    patches_test = extract_patches_nonoverlap(
        img_test_normalized, args.patch_size).astype(np.float32)
    patches_test_ref = extract_patches_nonoverlap(binary_ref, args.patch_size)
    print(patches_test.shape)

    if args.resunet_a:
        model = ResUnetA(num_classes=args.num_classes,
                         img_size=args.patch_size,
                         multitasking=args.use_multitasking,
                         in_channels=patches_test.shape[-1], device="cpu")
    else:
        model = UNet(num_classes=args.num_classes,
                     in_channels=patches_test.shape[-1], device="cpu")
    if os.path.isdir(args.model_path):
        restore_model(args.model_path, model)
    else:
        restore_variables(args.model_path, model)
    apply_fn = make_apply_fn(model, device)

    preds = predict_patches(apply_fn, patches_test, batch_size=args.batch_size)
    print("=" * 40)
    print("[TEST]")
    seg = preds["seg"] if args.use_multitasking else preds
    seg_pred = np.argmax(seg, axis=-1)

    true_labels = patches_test_ref.reshape(-1)
    predicted_labels = seg_pred.reshape(-1)
    metrics = compute_metrics(true_labels, predicted_labels)
    cm = confusion_matrix(true_labels, predicted_labels)
    print("Confusion  matrix \n", cm)
    print()
    print("Accuracy: ", metrics[0])
    print("F1score: ", metrics[1])
    print("Recall: ", metrics[2])
    print("Precision: ", metrics[3])
    ious = iou_per_class(cm)
    print("IoU per class: ", 100.0 * ious)
    print("mIoU: ", 100.0 * ious.mean())

    H, W = binary_ref.shape
    if args.overlap_stride and args.overlap_stride < args.patch_size:
        img_reconstructed, _ = predict_scene_overlap(
            apply_fn, img_test_normalized, args.patch_size,
            stride=args.overlap_stride, batch_size=args.batch_size,
            multitask=args.use_multitasking)
        print(f"[overlap-averaged reconstruction, stride={args.overlap_stride}]")
    else:
        img_reconstructed = reconstruct_from_patches(seg_pred, H, W, order="row")
    os.makedirs(args.output_path, exist_ok=True)
    _save_image(os.path.join(args.output_path, "pred_seg_reconstructed.jpeg"),
                class_ids_to_rgb(img_reconstructed, LABEL_DICT))

    if args.use_multitasking:
        print(MULTITASK_VIZ_NOTE)
    return metrics, cm


if __name__ == "__main__":
    main()
