#!/usr/bin/env python
"""End-to-end quickstart of the PyTorch port on synthetic data (the
counterpart of examples/quickstart.py): a 256x256 ISPRS-style scene
through the port's CLIs, preprocess to the packed format (64 px patches,
stride 32), train the multitask ResUnet-a for a few epochs (`--epochs`),
and test on the whole scene (README.md:5-21's workflow in
one script).

Run on the card:  python examples/quickstart_torch.py
Run on the CPU:   python examples/quickstart_torch.py --device cpu --epochs 1
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def synthetic_scene(size=256, seed=0):
    """(image (H, W, 3) uint8, class ids (H, W) uint8): coloured rectangles
    of classes 1-4 on class 0, each class its own colour over noise."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((size, size), np.uint8)
    for k in range(1, 5):
        for _ in range(6):
            r0, c0 = rng.integers(0, size - 16, 2)
            dh, dw = rng.integers(10, 60, 2)
            ids[r0:min(r0 + dh, size), c0:min(c0 + dw, size)] = k
    image = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    for k in range(5):
        image[ids == k] = (40 * k + 20, (60 * k + 35) % 256,
                           (90 * k + 70) % 256)
    return image, ids


def main(argv=None):
    """Returns {"workdir", "checkpoint", "predictions", "history",
    "metrics", "seconds"}: where each CLI wrote, the train CLI's history,
    the test CLI's (accuracy, F1, recall, precision) and each stage's
    seconds."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device for every CLI; default the card")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--workdir", default=None,
                   help="where to write; default a new temporary directory")
    args = p.parse_args(argv)

    from resuneta_torch.cli.preprocess_isprs import main as preprocess
    from resuneta_torch.cli.test_isprs import main as test
    from resuneta_torch.cli.train_isprs import main as train
    from resuneta_torch.data.isprs import LABEL_DICT, class_ids_to_rgb

    work = args.workdir or tempfile.mkdtemp(prefix="resuneta_quickstart_")
    dev = ["--device", args.device] if args.device else []
    print(f"workdir: {work}")
    scene_dir = os.path.join(work, "ISPRS_npy")
    os.makedirs(scene_dir, exist_ok=True)
    image, ids = synthetic_scene()
    for split in ("Train", "Test"):
        np.save(os.path.join(scene_dir, f"Image_{split}.npy"),
                image.transpose(2, 0, 1))
        np.save(os.path.join(scene_dir, f"Reference_{split}.npy"),
                class_ids_to_rgb(ids, LABEL_DICT).transpose(2, 0, 1))

    seconds = {}
    t0 = time.time()
    ds = os.path.join(work, "patches")
    preprocess(["--patch_size", "64", "--stride", "32",
                "--dataset_path", scene_dir, "--output_path", ds] + dev)
    seconds["preprocess"] = time.time() - t0

    t0 = time.time()
    results = os.path.join(work, "results")
    _, history = train(["--resunet_a", "True", "--multitasking", "True",
                        "--loss", "tanimoto", "-dp", ds, "-rp", results,
                        "-bs", "8", "-lr", "1e-4", "--epochs",
                        str(args.epochs), "-ps", "64"] + dev)
    seconds["train"] = time.time() - t0

    t0 = time.time()
    ckpt = os.path.join(results, "best_model.ckpt")
    preds = os.path.join(work, "preds")
    metrics, _ = test(["--model_path", ckpt, "--dataset_path", scene_dir,
                       "-ps", "64", "--use_multitasking", "--output_path",
                       preds, "--max_viz_patches", "2"] + dev)
    seconds["test"] = time.time() - t0
    print(f"\nDone. Outputs in {preds}")
    return {"workdir": work, "checkpoint": ckpt, "predictions": preds,
            "history": history, "metrics": metrics, "seconds": seconds}


if __name__ == "__main__":
    main()
