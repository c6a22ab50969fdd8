"""ISPRS inference/eval CLI of the port, with the argument surface of
resuneta_tpu/cli/test_isprs.py (test_ISPRS.py:215-236) plus --device.

    python -m resuneta_torch.cli.test_isprs --model_path weights.pt \
        --dataset_path <dir with Image_Test.npy, Reference_Test.npy> \
        --use_multitasking -ps 256

Flow (test_ISPRS.py:238-415): load the CHW test image and RGB reference,
normalize (norm_type 3 fits the scaler on the image itself), chop into
non-overlapping patches, predict in batches, print the confusion matrix,
accuracy, F1, recall, precision, per-class IoU and mIoU, and save the
reconstructed class map as pred_seg_reconstructed.jpeg. With
--use_multitasking, for the first --max_viz_patches patches, the
per-class/per-task grid pred{i}_classes.jpg (patch, seg, boundary and
distance reference and prediction) and the colour head's render
pred{i}_color.jpg (test_ISPRS.py:336-415): the reference labels come from
the label kernels on the device (`multitask_viz_panels`), the figures from
matplotlib, skipped with a printed line where it cannot be imported.
--model_path is a .pt state_dict, an .npz of flattened Flax variables, or
a training checkpoint directory of the port's train CLI (best_model.ckpt).
--resunet_a False evaluates the UNet baseline.
"""

import argparse
import os

import numpy as np

from ..utils.cli import str2bool

VIZ_TITLES = ("Patch", "Seg Ref", "Seg Pred", "Bound Ref", "Bound Pred",
              "Dist Ref", "Dist Pred")


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
    """Through matplotlib, else PIL; where neither imports, say so."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.imsave(path, rgb)
        return
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        print(f"neither matplotlib nor PIL can be imported: {path} is not "
              "written")
        return
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
        _save_multitask_viz(args, patches_test, patches_test_ref, preds,
                            device)
    return metrics, cm


def multitask_viz_panels(patch, ref_ids, pred, num_classes, device):
    """The arrays of one patch's figures (test_ISPRS.py:336-415;
    resuneta_tpu/cli/test_isprs.py:168-230), computed on `device`:
    patch (P, P, C) normalised to [0, 1], ref_ids (P, P) class ids, pred
    the patch's multitask outputs {"seg", "bound", "dist", "color"} (P, P,
    .) f32. Returns numpy: "img" the uint8 patch; "seg_ref" the one-hot of
    the ids (mod num_classes), "bound_ref" its boundary label
    (ops.boundary: K6 or K8 on the card), "dist_ref" its distance label
    (ops.distance: K5/K7); "hsv" the colour head scaled to cv2's HSV and
    cast to uint8, "rgb" its RGB render (hsv_to_rgb_cv2, clipped, uint8),
    "diff" the mean over channels of hsv minus the patch's HSV, scaled to
    [-1, 1]."""
    import torch

    from ..ops.boundary import get_boundary_label
    from ..ops.colorspace import hsv_to_rgb_cv2, rgb_to_hsv_cv2
    from ..ops.distance import get_distance_label

    img = (np.asarray(patch) * 255).clip(0, 255).astype(np.uint8)
    ids = torch.as_tensor(np.asarray(ref_ids).astype(np.int64) % num_classes,
                          device=device)
    onehot = torch.nn.functional.one_hot(ids, num_classes).to(torch.float32)
    hsv = (np.asarray(pred["color"]) * np.array([179, 255, 255])).astype(
        np.uint8)
    hsv_t = torch.as_tensor(hsv, device=device)
    rgb = hsv_to_rgb_cv2(hsv_t).clamp(0, 255).to(torch.uint8)
    diff = (hsv_t.float() - rgb_to_hsv_cv2(torch.as_tensor(
        img, device=device))).mean(dim=-1)
    rng = diff.max() - diff.min()
    diff = 2 * (diff - diff.min()) / torch.where(
        rng != 0, rng, torch.ones_like(rng)) - 1.0
    return {"img": img, "seg_ref": onehot.cpu().numpy(),
            "bound_ref": get_boundary_label(onehot).cpu().numpy(),
            "dist_ref": get_distance_label(onehot).cpu().numpy(),
            "hsv": hsv, "rgb": rgb.cpu().numpy(), "diff": diff.cpu().numpy()}


def _save_multitask_viz(args, patches_test, patches_test_ref, preds, device):
    """pred{i}_classes.jpg and pred{i}_color.jpg for the first
    min(N, --max_viz_patches) patches; the panels are computed whether or
    not matplotlib can draw them."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import cm as colormaps
    except ImportError:
        plt = None
        print("matplotlib cannot be imported: the multitask figures are "
              "not written")
    n = min(len(patches_test), args.max_viz_patches)
    for i in range(n):
        pv = multitask_viz_panels(patches_test[i], patches_test_ref[i],
                                  {k: v[i] for k, v in preds.items()},
                                  args.num_classes, device)
        if plt is None:
            continue
        grey = colormaps.Greys_r
        fig1, axes = plt.subplots(nrows=args.num_classes, ncols=7,
                                  figsize=(15, 10), squeeze=False)
        for c in range(args.num_classes):
            axes[c, 0].imshow(pv["img"])
            for task, head in enumerate(("seg", "bound", "dist")):
                axes[c, 2 * task + 1].imshow(pv[head + "_ref"][:, :, c],
                                             cmap=grey)
                axes[c, 2 * task + 2].imshow(preds[head][i, :, :, c],
                                             cmap=grey)
            axes[c, 0].set_ylabel(f"Class {c}")
        for title, ax in zip(VIZ_TITLES, axes[0]):
            ax.set_title(title)
        plt.savefig(os.path.join(args.output_path, f"pred{i}_classes.jpg"))
        plt.close(fig1)

        fig2, (ax1, ax2, ax3) = plt.subplots(nrows=1, ncols=3,
                                             figsize=(10, 5))
        ax1.set_title("Original")
        ax1.imshow(pv["img"])
        ax2.set_title("Pred HSV in RGB")
        ax2.imshow(pv["rgb"])
        ax3.set_title("Difference between both")
        ax3.imshow(pv["diff"], cmap=grey)
        plt.savefig(os.path.join(args.output_path, f"pred{i}_color.jpg"))
        plt.close(fig2)


if __name__ == "__main__":
    main()
