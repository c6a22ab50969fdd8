#!/usr/bin/env python3
"""Where the time of one 32-patch inference forward of the PyTorch port goes
on the card: torch.profiler over warm forwards of ResUnet-a d6 (5 classes,
256 px, multitask, bf16, seeded random weights) in the ids regime of
make_seg_ids_fn, summed by device kernel.

    python3 tools/torch_profile_infer.py [--batch 32] [--iters 5]
                                         [--fwd-wide]

--fwd-wide is ResUnetA's fwd_wide (the reference's
RESUNETA_CONVSEG_FWD_WIDE=1): the C = 256 and 512 eval segments through
K1 too; the other mode arguments route train mode only.

Prints one JSON line: the card (nvidia-smi name and power limit), the host
wall time per forward, the device busy time per forward (sum of kernel
times), the busy share, and the kernels by total device time with the share
that K1 (tma_fwd_kernel) and cuDNN's
convolutions take.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--fwd-wide", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from resuneta_torch.infer.sliding import make_seg_ids_fn
    from resuneta_torch.models import ResUnetA

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    model = ResUnetA(5, img_size=256, multitasking=True, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0),
                     fwd_wide=args.fwd_wide)
    fn = make_seg_ids_fn(model, norm_type=1)
    x = np.random.default_rng(0).integers(
        0, 256, (args.batch, 256, 256, 3), dtype=np.uint8)
    for _ in range(3):
        fn(x).cpu()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(args.iters):
            fn(x).cpu()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / args.iters

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
    busy = sum(kernels.values()) / args.iters
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])

    def share(pred):
        return sum(v for k, v in kernels.items() if pred(k)) / args.iters

    def is_k1(k):   # K1's kernel
        return "tma_fwd_kernel" in k

    k1 = share(is_k1)
    conv = share(lambda k: any(s in k.lower() for s in (
        "conv", "xmma", "implicit", "gemm", "sm90", "cutlass", "cudnn"))
        and not is_k1(k))
    print(json.dumps({
        "card": smi, "batch": args.batch, "iters": args.iters,
        "fwd_wide": args.fwd_wide,
        "wall_ms_per_forward": wall_ms, "device_busy_ms_per_forward": busy,
        "busy_share": busy / wall_ms,
        "k1_ms_per_forward": k1, "other_conv_ms_per_forward": conv,
        "rest_ms_per_forward": busy - k1 - conv,
        "top_kernels_ms_per_forward": [[k[:90], v / args.iters]
                                       for k, v in ranked[:args.top]],
        "n_kernel_names": len(kernels)}))


if __name__ == "__main__":
    main()
