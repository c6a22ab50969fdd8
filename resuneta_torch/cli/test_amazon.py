"""Amazon test CLI of the port (resuneta_tpu/cli/test_amazon.py, the
equivalent of amazon_py/test_amazon.py), with the train CLI's arguments
plus --model_path, --output_path and --thresholds.

    python -m resuneta_torch.cli.test_amazon --dataset_path <Amazon_npy> \
        --model_path <results>/best_model.ckpt [--resunet_a True \
        --multitasking True] -ps 128 [--device cpu]

Restores a checkpoint of the train CLI (train/checkpoint.restore), runs
the whole-scene prediction over the test tiles on the device and prints
the confusion matrix, accuracy, F1, recall, precision, the alarm area, the
test time and the threshold sweep's recall, precision and alarm-area
curves (matrics_AA_recall, utils2.py:312-356). Writes
prob_reconstructed.npy under --output_path, and color_map.png and
threshold_sweep.png where matplotlib is installed.
"""

import argparse
import os

import numpy as np

from .train_amazon import build_parser as _train_parser


def build_parser():
    parser = argparse.ArgumentParser(parents=[_train_parser()], add_help=False,
                                     conflict_handler="resolve")
    parser.add_argument("--model_path", type=str, required=True,
                        help="checkpoint dir saved by training (best_model.ckpt)")
    parser.add_argument("--output_path", type=str, default="results/amazon_preds")
    parser.add_argument("--thresholds", type=float, nargs="*",
                        default=list(np.round(np.arange(0.05, 1.0, 0.05), 3)))
    return parser


def _save_plots(out, thresholds, curves, cmap):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    from ..infer.amazon import rgb_image

    plt.imsave(os.path.join(out, "color_map.png"),
               rgb_image(cmap).astype(np.uint8))
    fig = plt.figure()
    for curve, label in zip(curves, ("recall", "precision", "alarm area")):
        plt.plot(thresholds, curve, label=label)
    plt.legend()
    plt.xlabel("threshold")
    plt.savefig(os.path.join(out, "threshold_sweep.png"))
    plt.close(fig)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..infer.amazon import color_map, matrics_AA_recall, prediction
    from ..infer.sliding import make_apply_fn
    from ..train import checkpoint, create_train_state
    from .train_amazon import (build_model, load_amazon_scene, report,
                               tiles_mask)

    device = resolve_device(args.device)
    image_array, image_ref, final_mask, mask_tiles = load_amazon_scene(
        args, device)
    mask_ts = tiles_mask(mask_tiles, args.test_tiles)

    state = create_train_state(build_model(args, image_array.shape[-1],
                                           device))
    state, _ = checkpoint.restore(args.model_path, state)

    (ref_final, pre_final, prob_rec, ref_rec, ref_clip, clip_mask,
     time_ts) = prediction(make_apply_fn(state.model, device), image_array,
                           image_ref, final_mask, mask_ts, args.patch_size,
                           args.area)
    metrics, cm = report(ref_final, pre_final, time_ts, "Alarm area:")

    sweep = matrics_AA_recall(args.thresholds, prob_rec, ref_clip,
                              clip_mask, args.area)
    curves = 100 * sweep[:, 0], 100 * sweep[:, 1], 100 * sweep[:, 2]
    print("Thresholds:", list(args.thresholds))
    print("Recall curve:", np.round(curves[0], 2).tolist())
    print("Precision curve:", np.round(curves[1], 2).tolist())
    print("Alarm-area curve:", np.round(curves[2], 2).tolist())

    os.makedirs(args.output_path, exist_ok=True)
    np.save(os.path.join(args.output_path, "prob_reconstructed.npy"), prob_rec)
    _save_plots(args.output_path, args.thresholds, curves,
                color_map(prob_rec, ref_rec, ref_clip, clip_mask, th=0.5))
    return metrics, cm


if __name__ == "__main__":
    main()
