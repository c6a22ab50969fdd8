#!/usr/bin/env python3
"""Where the time of one train step of the PyTorch port goes on the card:
torch.profiler over warm steps of the ISPRS multitask step (ResUnet-a d6,
5 classes, bf16, Adam 1e-4, Tanimoto on the four heads, seeded random
weights, uint8 patches and class ids through make_device_pipeline),
summed by device kernel.

    python3 tools/torch_profile_train.py [--patch 256] [--batch 16]
                                         [--iters 5] [--routing dense|nhwc]
                                         [--cudnn-benchmark]
                                         [--segment-mode 0|1|2]
                                         [--bwd-wide] [--fwd-wide]
                                         [--dense-tail 0|1|2]

--patch is the patch side (a multiple of 32; bench.py's rows are 256 px
at batch 16, 512 px at batch 8 and 1024 px at batch 2). --routing picks
the model's train-mode routing: the dense trunk (the card's default; 1x1
convs through K3 and K4) or NHWC (dense_trunk=False). --cudnn-benchmark
sets torch.backends.cudnn.benchmark for this process, so cuDNN times its
algorithms for each convolution shape at first use instead of taking its
heuristic's choice (the train step leaves the switch as the caller set
it). --segment-mode, --bwd-wide, --fwd-wide and --dense-tail are
ResUnetA's segment_mode, bwd_wide, fwd_wide and dense_tail: the
reference's opt-in train modes, off by default (models/resuneta.py).
Prints one JSON line: the card (nvidia-smi name and power limit), the
routing and modes, the host wall time per step (without the profiler,
and under it), the peak device memory (allocated blocks, and the bytes
the tensors requested), the device busy time per step (sum
of kernel times, under the profiler), the busy share, the time of each of
the port's kernels (K1 tma_fwd_kernel, K2 dgrad/wgrad at C <= 128, K9 dgrad/wgrad at C =
256, their reduce_rows and reduce_cols, K3 k3_* (bf16) and densemm_*
(f32, and the fixed-order sum of the bf16 wgrad), K4 poolconv_*, the
EDT's banded jfa_pass and its cluster kernel jfa_cluster (K5 and K7
alike), and
Canny's canny_tile_kernel (pass 1) and canny_kernel (pass 2): K6 up to
384 px, K8 above), cuDNN/CUTLASS convolutions and
GEMMs, the top kernels by total device time, the operators by device
time with their input shapes, and the host operators by self CPU time
(calls and ms per step).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _k2(name, wide):
    # K3's and K4's kernels carry K2's names after their own prefix; K9 is
    # K2's template at C = 256 (tma_dgrad_kernel<T, 256, HALO>,
    # tma_wgrad_kernel<256, HALO>)
    return lambda k: name in k and "densemm" not in k and \
        "poolconv" not in k and "k3_" not in k and \
        bool(re.search(r"[<,] ?256[,>]", k)) == wide


GROUPS = {
    "K1 tma_fwd_kernel": lambda k: "tma_fwd_kernel" in k,
    "K2 dgrad_kernel": _k2("dgrad_kernel", False),
    "K2 wgrad_kernel": _k2("wgrad_kernel", False),
    "K9 dgrad_kernel": _k2("dgrad_kernel", True),
    "K9 wgrad_kernel": _k2("wgrad_kernel", True),
    "K2/K9 reduce_rows + reduce_cols": lambda k: "reduce_rows" in k or
    "reduce_cols" in k,
    "K3 k3_fwd_kernel": lambda k: "k3_fwd_kernel" in k,
    "K3 k3_rowsum_kernel": lambda k: "k3_rowsum_kernel" in k,
    "K3 k3_dgrad_kernel": lambda k: "k3_dgrad_kernel" in k,
    "K3 k3_wgrad_kernel": lambda k: "k3_wgrad_kernel" in k,
    "K3 densemm_fwd_kernel": lambda k: "densemm_fwd_kernel" in k,
    "K3 densemm_dgrad_kernel": lambda k: "densemm_dgrad_kernel" in k,
    "K3 densemm_wgrad_kernel": lambda k: "densemm_wgrad_kernel" in k,
    "K3 densemm_reduce_kernel": lambda k: "densemm_reduce_kernel" in k,
    "K4 poolconv_fwd": lambda k: "poolconv_fwd" in k,
    "K4 poolconv_bwd": lambda k: "poolconv_bwd" in k,
    "K4 poolconv_reduce": lambda k: "poolconv_reduce" in k,
    "K5/K7 jfa_pass": lambda k: "jfa_pass" in k,
    "K5/K7 jfa_cluster": lambda k: "jfa_cluster" in k,
    "K6/K8 canny_tile_kernel": lambda k: "canny_tile_kernel" in k,
    "K6/K8 canny_kernel": lambda k: "canny_kernel" in k,
}


def _library_conv(k):
    low = k.lower()
    return any(s in low for s in ("conv", "xmma", "implicit", "gemm", "sm90",
                                  "cutlass", "cudnn", "wgrad", "dgrad")) \
        and not any(g(k) for g in GROUPS.values())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--patch", type=int, default=256)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--routing", choices=("dense", "nhwc"),
                        default="dense")
    parser.add_argument("--cudnn-benchmark", action="store_true",
                        help="let cuDNN time its algorithms per shape "
                             "(torch.backends.cudnn.benchmark)")
    parser.add_argument("--segment-mode", choices=("0", "1", "2"),
                        default="1")
    parser.add_argument("--bwd-wide", action="store_true")
    parser.add_argument("--fwd-wide", action="store_true")
    parser.add_argument("--dense-tail", choices=("0", "1", "2"),
                        default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from resuneta_torch import losses
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.models import ResUnetA
    from resuneta_torch.train import create_train_state, make_train_step
    from resuneta_torch.utils import xprof

    torch.backends.cudnn.benchmark = args.cudnn_benchmark

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    P = args.patch
    model = ResUnetA(5, img_size=P, multitasking=True, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0),
                     dense_trunk=None if args.routing == "dense" else False,
                     segment_mode=args.segment_mode, fwd_wide=args.fwd_wide,
                     bwd_wide=args.bwd_wide, dense_tail=args.dense_tail)
    state = create_train_state(model, "adam", 1e-4)
    step = make_train_step(losses.make_losses("tanimoto"),
                           {h: 1.0 for h in ("seg", "bound", "dist", "color")},
                           True, preprocess=make_device_pipeline(5, 1))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 5, (args.batch, 8, 8)).repeat(P // 8, 1).repeat(
        P // 8, 2)
    raw = {"image_u8": rng.integers(0, 256, (args.batch, P, P, 3),
                                    dtype=np.uint8),
           "label_ids": ids.astype(np.uint8),
           "aug": rng.integers(0, 5, args.batch)}
    for i in range(3):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        state, row = step(state, raw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # the tensors' own bytes at their peak, without the allocator's
    # rounding of blocks, which depends on what was allocated before
    peak_requested = torch.cuda.memory_stats().get("requested_bytes.all.peak")
    # the wall time without the profiler, whose host overhead is large here
    t0 = time.time()
    for _ in range(args.iters):
        state, row = step(state, raw)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / args.iters

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.time()
        for _ in range(args.iters):
            state, row = step(state, raw)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3 / args.iters

    kernels = xprof.op_times_ms(prof)
    busy = sum(kernels.values()) / args.iters
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])

    def share(pred):
        return sum(v for k, v in kernels.items() if pred(k)) / args.iters

    groups = {name: share(pred) for name, pred in GROUPS.items()}
    conv = share(_library_conv)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_top = [[e.key[:60], e.count / args.iters,
                 e.self_cpu_time_total / 1e3 / args.iters]
                for e in host[:args.top]]
    ops = sorted(prof.key_averages(group_by_input_shape=True),
                 key=lambda e: -e.device_time_total)
    shaped = [[e.key[:40], str(e.input_shapes)[:160], e.count / args.iters,
               e.device_time_total / 1e3 / args.iters]
              for e in ops[:args.top]]
    print(json.dumps({
        "card": smi, "routing": args.routing, "patch": P,
        "cudnn_benchmark": args.cudnn_benchmark,
        "modes": {"segment_mode": args.segment_mode,
                  "bwd_wide": args.bwd_wide, "fwd_wide": args.fwd_wide,
                  "dense_tail": args.dense_tail},
        "dense_trunk_on": model.uses_dense_trunk(P, P),
        "tail_mode": model.tail_mode(P, P),
        "max_memory_allocated_bytes": peak,
        "max_memory_requested_bytes": peak_requested,
        "batch": args.batch,
        "iters": args.iters,
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_under_profiler": prof_wall_ms,
        "device_busy_ms_per_step": busy, "busy_share": busy / wall_ms,
        "port_kernels_ms_per_step": groups,
        "library_conv_gemm_ms_per_step": conv,
        "rest_ms_per_step": busy - sum(groups.values()) - conv,
        "top_kernels_ms_per_step": [[k[:90], v / args.iters]
                                    for k, v in ranked[:args.top]],
        "host_ops_calls_and_self_cpu_ms_per_step": host_top,
        "host_self_cpu_ms_per_step": sum(
            e.self_cpu_time_total for e in host) / 1e3 / args.iters,
        "n_kernel_names": len(kernels),
        "ops_by_device_ms_per_step_with_shapes": shaped}))


if __name__ == "__main__":
    main()
