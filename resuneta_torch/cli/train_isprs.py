"""ISPRS training CLI of the port, with the argument surface of
resuneta_tpu/cli/train_isprs.py (train_ISPRS.py:298-338) plus --device:
--resunet_a, --multitasking, --gpu_parallel, -rp/--results_path,
-cp/--checkpoint_path, -dp/--dataset_path, -bs, -lr, --loss
{weighted_cross_entropy,cross_entropy,tanimoto}, -optm {adam,sgd},
--num_classes, --epochs, -ps, --bound_weight, --dist_weight, --color_weight,
--dtype, --seed, --patience, --profile_dir.

    python -m resuneta_torch.cli.train_isprs --resunet_a True \
        --multitasking True -dp <packed dataset> -rp <results> [--device cpu]

A packed dataset (data/dataset.py, write_packed_dataset) trains through the
device pipeline; the reference's file-per-patch tree through
LegacyPatchDataset. The split is the JAX CLI's (data/split.py). --seed
seeds the port's own generators: the model's init and the shuffle (the
port's init is not JAX's). The best checkpoint goes to
<results>/best_model.ckpt (train/checkpoint.py), TensorBoard logs to
<results>/logs/{train,val} where tensorboardX is installed; -cp resumes
from a checkpoint with -lr as the new learning rate.

Data parallelism (parallel/launch.py main_data_parallel): --gpu_parallel
True with N > 1 visible cards trains on all of them, one process a card
(NCCL; -bs stays the global batch, each card takes -bs/N rows of it), as
the reference's MirroredStrategy does; with one card it is a no-op. Under
torchrun (WORLD_SIZE set) each process joins that group, on the card of
its LOCAL_RANK, or with --device cpu on the CPU over gloo:

    torchrun --nproc_per_node 2 -m resuneta_torch.cli.train_isprs ...
"""

import argparse
import os
import time

import numpy as np

from ..utils.cli import print_on_coordinator, str2bool


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--resunet_a", help="choose resunet-a model or not",
                        type=str2bool, default=False)
    parser.add_argument("--multitasking", help="choose resunet-a multitasking or not",
                        type=str2bool, default=False)
    parser.add_argument("--gpu_parallel",
                        help="choose 1 to train on multiple devices "
                             "(one process a card)",
                        type=str2bool, default=False)
    parser.add_argument("-rp", "--results_path",
                        help="Path where to save logs and model checkpoint. Logs and "
                             "checkpoint will be saved inside this folder.",
                        type=str, default="./results/results_run1")
    parser.add_argument("-cp", "--checkpoint_path",
                        help="Path where to load model checkpoint to continue "
                             "training, if needed", type=str, default=None)
    parser.add_argument("-dp", "--dataset_path", help="Path where to load dataset",
                        type=str, default="./DATASETS/patch_size=256_stride=32")
    parser.add_argument("-bs", "--batch_size", help="Batch size on training",
                        type=int, default=4)
    parser.add_argument("-lr", "--learning_rate", help="Learning rate on training",
                        type=float, default=1e-3)
    parser.add_argument("--loss", help="choose which loss you want to use",
                        type=str, default="weighted_cross_entropy",
                        choices=["weighted_cross_entropy", "cross_entropy", "tanimoto"])
    parser.add_argument("-optm", "--optimizer", help="Choose which optmizer to use",
                        type=str, choices=["adam", "sgd"], default="adam")
    parser.add_argument("--num_classes", help="Number of classes", type=int, default=5)
    parser.add_argument("--epochs", help="Number of epochs", type=int, default=500)
    parser.add_argument("-ps", "--patch_size", help="Size of patches extracted",
                        type=int, default=256)
    parser.add_argument("--bound_weight", help="Boundary loss weight",
                        type=float, default=1.0)
    parser.add_argument("--dist_weight", help="Distance transform loss weight",
                        type=float, default=1.0)
    parser.add_argument("--color_weight", help="HSV transform loss weight",
                        type=float, default=1.0)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Model compute dtype (params stay float32)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of epoch 0 here")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (raises without a card)")
    return parser


def main(argv=None):
    """Returns (state, history); (None, rank 0's history) where it spawned
    one rank a card."""
    args = build_parser().parse_args(argv)
    from ..parallel.launch import main_data_parallel

    return main_data_parallel(run, args, args.device, args.gpu_parallel)


def run(args, group=None):
    """The CLI's work in this process: alone, or as one rank of `group`."""
    import torch

    from ..data import LegacyPatchDataset, PackedDataset, make_device_pipeline
    from ..data.dataset import is_packed
    from ..data.split import train_test_split
    from ..device import resolve_device
    from ..losses import make_losses
    from ..models import ResUnetA, UNet
    from ..parallel import multihost, replicate_state
    from ..train import (TrainConfig, checkpoint, create_train_state,
                         make_eval_step, make_train_step, train_model)

    device = group.device if group is not None else resolve_device(
        args.device)
    print = print_on_coordinator(group)   # rank 0 alone prints

    print("=" * 30 + "INITIALIZING" + "=" * 30)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "CPU"
    print(f"DEVICES: [{device} ({name})]")
    if group is not None:
        print(f"Number of devices: {group.size} (data-parallel, "
              f"{group.backend}, one process a device)")

    # ---------- dataset ----------
    root = args.dataset_path
    if is_packed(root):
        full = PackedDataset(root)
        tr_idx, val_idx = train_test_split(np.arange(len(full)),
                                           test_size=0.2, random_state=42)
        train_ds, val_ds = full.subset(tr_idx), full.subset(val_idx)
        norm_type = full.meta.get("norm_type", 1)
        preprocess = make_device_pipeline(
            args.num_classes, norm_type, args.multitasking, device=device)
        channels = full.meta.get("channels", 3)
    else:
        full = LegacyPatchDataset(root, multitasking=args.multitasking)
        tr_idx, val_idx = train_test_split(np.arange(len(full)),
                                           test_size=0.2, random_state=42)
        train_ds, val_ds = full.subset(tr_idx), full.subset(val_idx)
        preprocess = None
        channels = 3

    # ---------- model ----------
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    generator = torch.Generator().manual_seed(args.seed)
    if args.resunet_a:
        if args.multitasking:
            print("Multitasking enabled!")
        else:
            print("Using simple ResUnet-a")
        model = ResUnetA(num_classes=args.num_classes, img_size=args.patch_size,
                         multitasking=args.multitasking, dtype=dtype,
                         in_channels=channels, generator=generator,
                         device=device)
    else:
        model = UNet(num_classes=args.num_classes, dtype=dtype,
                     in_channels=channels, generator=generator, device=device)

    state = create_train_state(model, optimizer=args.optimizer,
                               learning_rate=args.learning_rate)

    # ---------- losses ----------
    print("=" * 60)
    if args.loss == "cross_entropy":
        print("Using Cross Entropy")
    elif args.loss == "tanimoto":
        print("Using Tanimoto Dual Loss")
    else:
        print("Using Weighted cross entropy")
    loss_fns = make_losses(args.loss)
    loss_weights = {"seg": 1.0, "bound": args.bound_weight,
                    "dist": args.dist_weight, "color": args.color_weight}
    if args.multitasking:
        print(f"Loss Weights: {loss_weights}")
    print("=" * 60)

    # ---------- resume ----------
    if args.checkpoint_path is not None:
        print(f"[INFO] loading {args.checkpoint_path}...")
        print(f"[INFO] old learning rate: {float(state.learning_rate)}")
        state, meta = checkpoint.restore(
            args.checkpoint_path, state,
            learning_rate_override=args.learning_rate, group=group)
        print(f"[INFO] new learning rate: {float(state.learning_rate)}")
    state = replicate_state(state, group)

    train_step = make_train_step(loss_fns, loss_weights, args.multitasking,
                                 preprocess=preprocess, device=device,
                                 group=group)
    eval_step = make_eval_step(loss_fns, loss_weights, args.multitasking,
                               preprocess=preprocess, device=device,
                               group=group)

    if multihost.is_coordinator(group):
        os.makedirs(args.results_path, exist_ok=True)
    config = TrainConfig(
        results_path=args.results_path,
        batch_size=args.batch_size,
        epochs=args.epochs,
        multitasking=args.multitasking,
        patience=args.patience,
        seed=args.seed,
        profile_dir=args.profile_dir,
    )

    start = time.time()
    state, history = train_model(config, state, train_step, eval_step,
                                 train_ds, val_ds, group=group)
    print(f"\nTraining took: {(time.time() - start) / 3600} \n")
    return state, history


if __name__ == "__main__":
    main()
