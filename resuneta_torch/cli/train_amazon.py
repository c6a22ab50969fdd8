"""Amazon deforestation training CLI of the port, with the argument surface
of resuneta_tpu/cli/train_amazon.py (the runnable form of amazon_py/main.py)
plus --device.

    python -m resuneta_torch.cli.train_amazon --dataset_path <Amazon_npy> \
        --resunet_a True --multitasking True -ps 128 -bs 8 [--device cpu]

Flow (amazon_py/main.py:8-169): two 7-band year rasters (npy, CHW) are
stacked to 14 channels and normalized as a whole (on the device); the
3-class mask with a buffer-2 ring (mask_no_considered) and the 15-tile grid
with hand-picked train/val ids; per tile, patches with >= percent%
deforestation, x5 augmentation; weighted-CE training (weights [0.5, 0.5,
0]) with early stopping and the best checkpoint; then the whole-scene
prediction over the test tiles with area opening and masking, and the
confusion matrix, metrics and alarm area.

The dataset comes one of three ways: the tile split (the default),
--preprocessed_path (a dataset of preprocess_amazon; the whole-scene eval
is skipped, as the JAX CLI does), or --use_tiles False (whole-scene strided
extraction in the valid footprint, main2_no_tiles.py, split 80/20 by
data/split.py). The model is UNet, or with --resunet_a True
ResUnetA(in_channels=<bands>, num_classes, img_size=ps, multitasking,
color_head=False); the multitask heads seg, bound and dist all take the WCE
loss with weight 1.0 and their labels come from the one-hot reference on
the device (make_label_head_pipeline). The step runs in f32, as the JAX
CLI's. --seed seeds the port's own generators (the model's init and the
shuffle). Entry points run on the card unless --device names another,
and raise without one.

Data parallelism as in cli/train_isprs.py (parallel/launch.py
main_data_parallel): --gpu_parallel True with N > 1 visible cards trains
one process a card (NCCL; -bs the global batch), a no-op with one card;
under torchrun each process joins that group (gloo with --device cpu).
Every rank builds the same dataset; the whole-scene eval shards the patch
grid over the ranks, and rank 0 alone prints, saves and writes the
probability map.
"""

import argparse
import os
import time

import numpy as np

from ..utils.cli import print_on_coordinator, str2bool


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_path", type=str, default="./DATASETS/Amazon_npy")
    parser.add_argument("--image_t1", type=str, default="clipped_raster_004_66_2018.npy")
    parser.add_argument("--image_t2", type=str, default="clipped_raster_004_66_2019.npy")
    parser.add_argument("--reference", type=str,
                        default="labels/binary_clipped_2019.npy")
    parser.add_argument("--past_reference", type=str, nargs="*",
                        default=["labels/binary_clipped_2013_2018.npy",
                                 "labels/binary_clipped_1988_2012.npy"])
    parser.add_argument("--resunet_a", type=str2bool, default=False)
    parser.add_argument("--multitasking", type=str2bool, default=False)
    parser.add_argument("-rp", "--results_path", type=str, default="./results/amazon_run1")
    parser.add_argument("-bs", "--batch_size", type=int, default=8)
    parser.add_argument("-lr", "--learning_rate", type=float, default=1e-4)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("-ps", "--patch_size", type=int, default=128)
    parser.add_argument("--stride", type=int, default=None,
                        help="default: patch_size // 8 (main.py:78)")
    parser.add_argument("--percent", type=float, default=5.0,
                        help="min %% deforestation per kept patch")
    parser.add_argument("--buffer", type=int, default=2)
    parser.add_argument("--area", type=int, default=11,
                        help="area-opening threshold at eval (main.py:143)")
    parser.add_argument("--num_classes", type=int, default=3)
    parser.add_argument("--train_tiles", type=int, nargs="*", default=[1, 6, 7, 13])
    parser.add_argument("--val_tiles", type=int, nargs="*", default=[5, 12])
    parser.add_argument("--test_tiles", type=int, nargs="*",
                        default=[2, 3, 4, 8, 9, 10, 11, 14, 15])
    parser.add_argument("--norm_type", type=int, default=1, choices=[1, 2, 3],
                        help="whole-image normalization (utils.py:242-253 numbering)")
    parser.add_argument("--class_weights", type=float, nargs="*", default=[0.5, 0.5, 0.0])
    parser.add_argument("--gpu_parallel", type=str2bool, default=False)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip_eval", type=str2bool, default=False)
    parser.add_argument("--preprocessed_path", type=str, default=None,
                        help="dataset dir written by preprocess_amazon (train/val"
                             " splits + manifest); skips scene loading for "
                             "training (whole-scene eval still needs rasters)")
    parser.add_argument("--use_tiles", type=str2bool, default=True,
                        help="False = whole-scene strided extraction with the valid"
                             "-footprint filter instead of the 15-tile split (the "
                             "main2_no_tiles.py variant)")
    parser.add_argument("--mask_ref", type=str, default=None,
                        help="valid-footprint mask npy (used when --use_tiles False)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (raises without a card)")
    return parser


def load_years(root, image_t1, image_t2):
    """The two years' rasters (CHW or HWC .npy) stacked on the channel
    axis: (H, W, C1 + C2) float32."""
    from ..data.isprs import load_npy_image

    img_t1 = load_npy_image(os.path.join(root, image_t1)).astype(np.float32)
    img_t2 = load_npy_image(os.path.join(root, image_t2)).astype(np.float32)
    if img_t1.ndim == 3 and img_t1.shape[0] < img_t1.shape[-1]:
        img_t1 = img_t1.transpose((1, 2, 0))
        img_t2 = img_t2.transpose((1, 2, 0))
    return np.concatenate((img_t1, img_t2), axis=-1)


def sum_rasters(root, paths):
    """The sum of the past-deforestation rasters; None for no path."""
    from ..data.isprs import load_npy_image

    past = None
    for p in paths:
        arr = load_npy_image(os.path.join(root, p))
        past = arr if past is None else past + arr
    return past


def normalize_scene(image_array, norm_type, device):
    """ops.normalize.normalization of the whole (H, W, C) raster on
    `device`, back as a float32 numpy array."""
    import torch

    from ..ops.normalize import normalization

    x = torch.from_numpy(image_array).to(device)
    return normalization(x, norm_type).cpu().numpy()


def load_amazon_scene(args, device):
    """The normalized 14-channel scene, the reference, the 3-class final
    mask and the tile grid."""
    from ..data.amazon import make_tile_mask
    from ..data.isprs import load_npy_image
    from ..ops.morphology import mask_no_considered

    root = args.dataset_path
    image_array = normalize_scene(
        load_years(root, args.image_t1, args.image_t2), args.norm_type,
        device)
    image_ref = load_npy_image(os.path.join(root, args.reference))
    past = sum_rasters(root, args.past_reference)
    if past is None:
        past = np.zeros_like(image_ref)

    H = min(image_array.shape[0], image_ref.shape[0], past.shape[0])
    W = min(image_array.shape[1], image_ref.shape[1], past.shape[1])
    image_array, image_ref, past = (
        image_array[:H, :W], image_ref[:H, :W], past[:H, :W])

    final_mask = mask_no_considered(image_ref, args.buffer, past)
    mask_tiles = make_tile_mask(H, W)
    return image_array, image_ref, final_mask, mask_tiles


def build_model(args, channels, device):
    """ResUnetA (--resunet_a True; no colour head: HSV has no meaning for
    14 bands) or UNet, seeded from --seed, on `device`."""
    import torch

    from ..models import ResUnetA, UNet

    generator = torch.Generator().manual_seed(args.seed)
    if args.resunet_a:
        return ResUnetA(num_classes=args.num_classes, img_size=args.patch_size,
                        multitasking=bool(args.multitasking),
                        color_head=False, in_channels=channels,
                        generator=generator, device=device)
    return UNet(num_classes=args.num_classes, in_channels=channels,
                generator=generator, device=device)


def tiles_mask(mask_tiles, test_tiles):
    """1.0 on the pixels of `test_tiles`, 0.0 elsewhere."""
    mask_ts = np.zeros_like(mask_tiles, np.float32)
    for t in test_tiles:
        mask_ts[mask_tiles == t] = 1
    return mask_ts


def report(ref_final, pre_final, time_ts, area_label):
    """Print the confusion matrix, the metrics, the alarm area and the test
    time as the JAX CLIs do; returns (metrics, cm)."""
    from ..metrics import alarm_area, compute_metrics, confusion_matrix

    cm = confusion_matrix(ref_final, pre_final)
    metrics = compute_metrics(ref_final, pre_final)
    print("Confusion  matrix \n", cm)
    print("Accuracy: ", metrics[0])
    print("F1score: ", metrics[1])
    print("Recall: ", metrics[2])
    print("Precision: ", metrics[3])
    if cm.shape[0] > 1:
        print(area_label, alarm_area(cm) * 100)
    print("test time", time_ts)
    return metrics, cm


def main(argv=None):
    """Returns (state, history); (None, rank 0's history) where it spawned
    one rank a card."""
    args = build_parser().parse_args(argv)
    from ..parallel.launch import main_data_parallel

    return main_data_parallel(run, args, args.device, args.gpu_parallel)


def run(args, group=None):
    """The CLI's work in this process: alone, or as one rank of `group`."""
    stride = args.stride or args.patch_size // 8

    from ..data import ArrayDataset, make_label_head_pipeline
    from ..data.amazon import bal_aug_patches, patch_tiles
    from ..device import resolve_device
    from ..infer.amazon import prediction
    from ..infer.sliding import make_apply_fn
    from ..losses import weighted_categorical_crossentropy
    from ..parallel import multihost, replicate_state
    from ..train import (TrainConfig, create_train_state, make_eval_step,
                         make_train_step, train_model)

    device = group.device if group is not None else resolve_device(
        args.device)
    print = print_on_coordinator(group)   # rank 0 alone prints
    if group is not None:
        print(f"Number of devices: {group.size} (data-parallel, "
              f"{group.backend}, one process a device)")

    def to_ds(p, r):
        onehot = np.eye(args.num_classes, dtype=np.float32)[np.asarray(r, np.int64)]
        if p.dtype != np.float32:
            p = p.astype(np.float32)  # keeps float32 memmaps lazy
        return ArrayDataset({"image": p, "seg": onehot})

    if args.preprocessed_path:
        import json
        root = args.preprocessed_path
        with open(os.path.join(root, "manifest.json")) as f:
            manifest = json.load(f)
        args.class_weights = manifest.get("class_weights", args.class_weights)
        train_ds = to_ds(np.load(os.path.join(root, "train_images.npy"),
                                 mmap_mode="r"),
                         np.load(os.path.join(root, "train_labels.npy")))
        val_ds = to_ds(np.load(os.path.join(root, "val_images.npy"), mmap_mode="r"),
                       np.load(os.path.join(root, "val_labels.npy")))
        channels = manifest["channels"]
        args.skip_eval = True  # whole-scene eval needs the rasters
    else:
        image_array, image_ref, final_mask, mask_tiles = load_amazon_scene(
            args, device)
        channels = image_array.shape[-1]
        print(f"Input image shape: {image_array.shape}")
        if args.use_tiles:
            def build_split(tiles):
                p, r = patch_tiles(tiles, mask_tiles, image_array, final_mask,
                                   args.patch_size, stride)
                p, r = bal_aug_patches(args.percent, args.patch_size, p, r)
                return to_ds(p, r)

            train_ds = build_split(args.train_tiles)
            val_ds = build_split(args.val_tiles)
        else:
            # main2_no_tiles.py: whole-scene strided extraction gated on the
            # valid footprint, then an 80/20 split
            from ..data.amazon import (bal_aug_patches2,
                                       extract_patches_right_region)
            from ..data.isprs import load_npy_image
            from ..data.split import train_test_split

            if args.mask_ref:
                mask_valid = load_npy_image(
                    os.path.join(args.dataset_path, args.mask_ref))[
                        :image_ref.shape[0], :image_ref.shape[1]]
            else:
                mask_valid = np.full_like(image_ref, -1, np.float64)
            p, r = extract_patches_right_region(
                image_array, final_mask, mask_valid, args.patch_size, stride,
                args.percent)
            p, r = bal_aug_patches2(args.percent, args.patch_size,
                                    np.asarray(p), np.asarray(r))
            tr, va = train_test_split(np.arange(len(p)), test_size=0.2,
                                      random_state=42)
            train_ds, val_ds = to_ds(p[tr], r[tr]), to_ds(p[va], r[va])
    print(f"Training patches: {len(train_ds)}  Validation patches: {len(val_ds)}")

    multitasking = bool(args.multitasking and args.resunet_a)
    model = build_model(args, channels, device)
    state = replicate_state(create_train_state(model, "adam",
                                               args.learning_rate), group)

    wce = weighted_categorical_crossentropy(args.class_weights)
    if multitasking:
        # the reference compiles the same wce for every head with weight 1.0
        # (main_mabel_resuneta.py:195-201)
        loss_fns = {"seg": wce, "bound": wce, "dist": wce}
        loss_weights = {"seg": 1.0, "bound": 1.0, "dist": 1.0}
        preprocess = make_label_head_pipeline(device)
    else:
        loss_fns = {"seg": wce}
        loss_weights = {}
        preprocess = None
    train_step = make_train_step(loss_fns, loss_weights, multitasking,
                                 preprocess=preprocess, device=device,
                                 group=group)
    eval_step = make_eval_step(loss_fns, loss_weights, multitasking,
                               preprocess=preprocess, device=device,
                               group=group)

    config = TrainConfig(results_path=args.results_path,
                         batch_size=args.batch_size, epochs=args.epochs,
                         multitasking=multitasking, patience=10, delta=1e-4,
                         seed=args.seed)
    t0 = time.time()
    state, history = train_model(config, state, train_step, eval_step,
                                 train_ds, val_ds, group=group)
    print("training time", time.time() - t0)

    if args.skip_eval:
        return state, history

    # ---------- whole-scene evaluation on the test tiles ----------
    mask_ts = tiles_mask(mask_tiles, args.test_tiles)
    (ref_final, pre_final, prob_rec, _, _, _, time_ts) = prediction(
        make_apply_fn(state.model, device), image_array, image_ref,
        final_mask, mask_ts, args.patch_size, args.area, group=group)
    if multihost.is_coordinator(group):
        report(ref_final, pre_final, time_ts, "Area to be analyzed")
        np.save(os.path.join(args.results_path, "prob_reconstructed.npy"),
                prob_rec)
    return state, history


if __name__ == "__main__":
    main()
