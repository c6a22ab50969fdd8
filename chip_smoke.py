#!/usr/bin/env python3
"""Drive the PyTorch port (resuneta_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. build  - compile every CUDA kernel from resuneta_torch/kernels/csrc into
            build/kernels/ (one nvcc per source, started together) and print
            the card's name and power limit as nvidia-smi gives them.
2. k1     - K1 (fused BN affine -> ReLU -> dilated 3x3 conv) against its
            plain PyTorch version on the card, in bf16, at every shape the
            256 px inference path gives it (batch 32) plus the wide tier's
            (WIDE_LEVELS: C = 256 and 512 of the fwd_wide forward, C = 256
            of the bwd_wide steps at 256, 512 and 1024 px); times the
            kernel, the plain version and one cuDNN bf16 conv of the same z
            (library_ms, a yardstick the port never calls) beside the
            least time the card could take (bound_ms). Each k1 row names
            the design that took it (convseg.K1_DESIGN): "tma_wgmma", the
            TMA-fed wgmma kernel, at every C, and its work item (pixels,
            output channels; convseg.K1_ITEMS): 64 x 256 at C = 512.
3. slice, slice_wide - ISPRS whole-scene inference of ResUnet-a d6 at full
            width (5 classes, 256 px, multitask, bf16, seeded random
            weights): a 2048x2048 uint8 scene through
            predict_scene(make_seg_ids_fn(...), ids_only=True), batch 32.
            Checks the ids, that K1 launched 44 times per batch (60 with
            fwd_wide=True, slice_wide: RB(256) and RB(512) too), and one
            patch's seg probabilities (f32 model, card against the CPU
            plain path); times a warm second pass.
4. k2, k10 - K2 (the segment's one-pass backward) against its plain
            version at the 11 shapes of the 256 px train step (batch 16,
            bf16), K9 (the same at C = 256) at the bwd_wide steps' RB(256)
            shapes, and K2 without the ReLU (the tail's head segments):
            the seven cotangents it folds into; times the kernel, the plain
            version and one cuDNN convolution_backward (dgrad + wgrad +
            bias, no BN sums) of the same precomputed bf16 z and g
            (library_ms). k10: the segment of mode "2" (a cuDNN forward,
            the K2 backward) at the 11 shapes, through autograd, against
            its plain version. Each k2 row names the design that took
            it (convseg.k2_design): "tma_wgmma", the TMA-fed wgmma dgrad
            and wgrad, at every C (K9 in two 128-channel halves of N).
5. k3, k4 - K3 (the 1x1 conv over concat parts) and K4 (max pool -> 1x1
            conv), forward and backward, against their plain versions at
            the 12 and 3 shapes of the dense-trunk train step (batch 16,
            bf16; K4's inputs with planted exact ties); times each way
            beside the bound, the plain version and the library calls: a
            cuDNN 1x1 conv and convolution_backward of the materialised
            concat/upsample (K3), F.max_pool2d then that conv, two calls,
            whose backward routes a tie to one element (K4). Each k4 row
            names K4's design (poolconv.K4_DESIGN: one pass forward; one
            pass over x and g, then a fixed-order sum, backward) and its
            share of the bound.
6. k5, k6 - the JFA distance transform and the Canny boundary kernels
            against their plain versions, bit for bit, on the 80 planes of
            256^2 a 16 x 5-class batch gives them (Voronoi blobs, uniform
            noise, an all-zero and an all-one plane); no PyTorch call
            computes either, so library_ms is null. The k5 row names the
            EDT's design (distance.plan: "cluster" here) and its launches;
            the k6 row Canny's (two passes: a tiled stencil kernel, then
            the hysteresis kernel, which returns at once on planes pass 1
            did not flag), its launches, ms, bound and share of it.
7. k8, k5_layouts_256, k5_512, k7 - the row-tiled Canny and the EDT on
            the planes of the large patches, bit for bit against their
            plain versions (K7's band decomposition) and the whole-plane
            plain versions: K8 on the 40 planes of 512^2 an 8 x 5-class
            batch gives and the 10 of 1024^2 of a 2 x 5-class batch, timed
            at its default tile and at others (ms_by_tile), with its
            launches and share of the bound; the EDT
            kernels, which serve K5's planes and K7's alike, on those and
            the 80 of 256^2, in their default design ("tail" at 512^2 and
            1024^2) and in every design and tile of EDT_LAYOUTS
            (ms_by_design).
            k7_k8_forced_256: K8 forced through `tile` against K6 on the
            80 planes of 256^2.
8. train  - the ISPRS multitask train step at full width (bf16, batch 16,
            256 px, Adam 1e-4, Tanimoto on the four heads, uint8 patches and
            Voronoi-blob class ids through make_device_pipeline) in the
            dense-trunk routing, the card's default: per step 44 K1
            launches, 44 K2 calls of 4 launches, 12 K3 calls each way (1
            launch a call forward; 3 backward, 4 where a part is
            upsampled), 3 K4 calls each way (1 and 2 launches), one EDT
            call of one launch and one K6 call of 2 launches (pass 1 and
            pass 2); finite metric rows; the
            loss after 10 steps on one batch below the first step's. Times
            the warm steps (median, with a synchronise). Then 3 steps of
            the NHWC routing (dense_trunk=False: no K3, no K4), and one
            64 px, bs 2, f32 dense-trunk step, card against the CPU plain
            path, beside the CPU with one thread against many
            (step_card_vs_cpu; the card's step test in
            tests/test_torch_gpu.py runs the same function). Its row also
            holds the device ms a step of PROFILE_STEPS more steps under
            torch.profiler (resuneta_torch.utils.xprof) and the busy
            share: that over the median warm step.
9. train_512, train_1024 - the same step at bench.py's large-patch rows:
            512 px, batch 8, 5 steps, and 1024 px, batch 2, 4 steps,
            without remat: per step the 256 px step's K1-K4 launches, and
            on the label side one EDT call of 8 launches (512 px) or 9
            (1024 px) and one K8 call of 2 launches (no K6); finite rows, a
            falling
            loss, the median warm step, patches/s and peak memory.
10. train_wide, train_wide_1024, train_seg2, train_tail1 - the reference's
            opt-in train modes (ResUnetA arguments, TRAIN_MODES), 3 steps
            each: bwd_wide at 256 px x 16 and 1024 px x 2 (per step 56 K1
            launches and 56 K2 calls, 12 of them K9), segment_mode="2" at
            256 px (no K1, 44 K2 calls from K10's backward, NHWC: no K3,
            K4), dense_tail="1" at 256 px (49 and 49); the other counts as
            the default step's; then each mode's 64 px f32 step, card
            against the CPU plain path.
11. train_cli - the training runtime through its entry point: a packed
            dataset of 10 seeded 256 x 256 x 3 patches with the 5
            augmentation variants (write_packed_dataset under
            build/train_cli/) trained by resuneta_torch.cli.train_isprs.main
            in this process (multitask ResUnet-a d6 at full width, Tanimoto,
            bf16, batch 8, 2 epochs of 5 train steps and 1 eval step), then
            resumed from its best checkpoint for 1 epoch at lr 5e-4. Fails
            unless the history is finite, the checkpoint and its meta JSON
            exist, the checkpoint restored into a fresh state equals the
            saved tensors bit for bit, the resumed state has lr 5e-4 and the
            saved step plus 5, the loader ran its native row gather, and
            each run's launches equal expected_counts for its train steps
            plus expected_eval_counts for its eval steps (44 K1 and the
            labels' EDT and Canny launches each). Its row: patches/s and
            seconds of each epoch, the phase's wall time, the launches.
12. amazon - the Amazon deforestation workload through its three CLIs
            in this process (phase_amazon): a seeded scene of two 7-band
            years at 2560 x 1536 (5 x 3 tiles of 512^2) under
            build/amazon/; preprocess_amazon at 128 px, stride 128;
            train_amazon with the full-width 14-band multitask ResUnet-a
            d6 (no colour head, WCE, f32, 128 px, batch 8, 1 epoch) in tile
            mode with its whole-scene eval, and from the preprocessed set;
            test_amazon on the best checkpoint, whose metrics and
            probability map must equal the training eval's. Each CLI's
            launches against expected_counts(patch=128, f32=True) for its
            train steps, expected_eval_counts for its eval steps and 44 K1
            a 32-patch batch of the scene. Then the 64 px Amazon step, card
            against the CPU plain path, beside the CPU with one thread
            against many (amazon_64px_f32); 10 bare warm steps of the 128
            px, batch 8 step with their launches (amazon_warm_steps: the
            median warm step and patches/s; the CLI epochs' rates are cold
            smoke readings); K3 and K4 in f32 alone at the 128 px step's
            shapes (k3_f32_128, k4_f32_128); K5 and K6 bit for bit on 28
            planes of 128^2 (k5_128: the EDT's cluster of 2 blocks,
            k6_128). Its row: each CLI epoch's patches/s, the scene's
            Mpix/s, the test time, peak memory and the card.
13. viz    - the test CLI's multitask figures (phase_viz): cli.test_isprs.
            main --use_multitasking --max_viz_patches 4 on a seeded
            1024x1024 scene at 256 px (the full-width f32 d6, batch 32)
            under build/viz/: the eval's 44 K1 plus, per visualised patch,
            one EDT (K5) and one Canny (K6, 2 launches) call on its
            reference; the figures where matplotlib imports (an earlier
            line says whether it does); the panels on the card against the
            CPU from the same predictions (labels and HSV bit for bit, the
            render within 1).
14. variants - the rest of the family (phase_variants): V1 through
            compat.Resunet_a(variant="v1") on 64 patches of 256 px, f32,
            batch 32 (44 K1 a batch; one patch card against CPU within
            SEG_ATOL); the legacy driver compat.UNet at UnetConfig() (512
            px, 5 classes, f32, batch 8) for one epoch on 16 seeded .npy
            pairs under build/legacy/, a fresh driver's loadWeight (bit for
            bit) and 2 predictions, each step's K1 and K2 launches; its 64
            px step card against CPU at LEGACY_STEP_TOL; ResNet50UNet (14
            bands, 3 classes) forward at 128 px x 8, card against CPU.
15. remat_1024 - the default 1024 px x 2 bf16 step, 3 steps without and 3
            with make_train_step(remat=True): launches as
            expected_counts(remat=...), rows within STEP_TOL's loss limit,
            each run's peak memory and median warm step.
16. dist   - data-parallel training (resuneta_torch.parallel), phase_dist:
            two ranks of one process each share this card over gloo
            (NCCL takes one card a rank), each with 8 rows of a global
            batch of 16, and take 3 SGD steps of the full-width multitask
            d6 at 256 px, bf16, with K1-K6 live on each; held against the
            same 3 steps in this process on the 16 rows (dist_compare: the
            rows, the SGD update, the BN running buffers, at STEP_TOL's
            limits), the ranks' parameters bit for bit, each rank's
            launches expected_counts(3). Then one epoch of train_model
            over the two ranks on train_cli's packed set: each rank's
            launches, and rank 0 alone printing and writing its
            checkpoint; then predict_scene_overlap(group=) of a 1024^2
            scene at stride 128 on the ranks (88 K1 a rank), bit for bit
            against this process at the per-rank batch. With two cards or
            more, the same steps over NCCL
            one card a rank, and cli.train_isprs --gpu_parallel True on
            every card; with one, the row says so. Its row: the readings,
            the step times of rank 0 and of this process (a smoke
            reading: two ranks share one card), the launches by rank.
17. space  - the train step height-sharded (phase_space): two gloo ranks
            share this card as a 1 x 2 (data, space) mesh
            (parallel.make_mesh_2d), each with the 16 rows' band of 128
            rows, and take dist's 3 SGD steps with K1-K4 off (the step
            enters convseg.disabled(), the reference's GSPMD routing: NHWC,
            every 3x3 conv on a halo through the host, the middle PSP's
            levels on gathered planes) and the pipeline on the gathered
            whole planes (per step one EDT and one Canny call); held by
            dist_compare against this process on the 16 rows inside
            convseg.disabled(). With two cards or more, the same over NCCL
            at 1 x 2 (halos on the card), with four or more at 2 x 2.
18. trajectory - the bf16 trajectory gate
            (resuneta_torch.utils.trajectory): the fixed 64 px multitask
            workload, 5 Adam steps in bf16 on the card; every loss within
            BAND of the port's CPU f32 pin.
19. quickstart - examples/quickstart_torch.py on the card under
            build/quickstart/: the synthetic 256^2 scene through the
            preprocess, train (3 epochs, 64 px) and test CLIs; a finite
            history, the checkpoint, the test's metrics and reconstruction.
20. phase_seconds line, kernels line (K1-K10; the launches count the
            train_cli, amazon, viz, variants, remat_1024, dist, space,
            trajectory and quickstart runs too; K3's and K4's f32_at_128
            the 128 px f32 calls, K5's and K6's at_128 the 128^2 planes),
            then the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, where torch.cuda.is_available() is false
or the package is not beside this file.
"""

import contextlib
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH = 32
PATCH = 256
SCENE = 2048
NUM_CLASSES = 5
# published H100 SXM peaks at 700 W (NVIDIA data sheet): dense bf16 tensor
# FLOP/s and HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# K1 shapes on the inference path: (C, H=W, dilations); launches per forward
# = 2 segments per dilation x (encoder + decoder ResBlock), C=128 has 3
# dilations in each
K1_LEVELS = ((32, 256, (1, 3, 15, 31)), (64, 128, (1, 3, 15, 31)),
             (128, 64, (1, 3, 15)))
# the opt-in wide tier's segments (K1 forward, K9 backward): (C, H=W,
# batch, dilations, path). Eval (fwd_wide): RB(256) at 32^2 and RB(512) at
# 16^2 of a 32-patch 256 px forward; train (bwd_wide): RB(256) at 32^2 x 16
# (256 px), 64^2 x 8 (512 px) and 128^2 x 2 (1024 px). 4 launches (calls)
# a dilation: 2 segments in the encoder's and the decoder's block.
WIDE_LEVELS = ((256, 32, BATCH, (1, 3, 15), "slice_wide"),
               (512, 16, BATCH, (1,), "slice_wide"),
               (256, 32, 16, (1, 3, 15), "train_wide"),
               (256, 64, 8, (1, 3, 15), "train_wide_512"),
               (256, 128, 2, (1, 3, 15), "train_wide_1024"))
# K1 per 32-patch forward with fwd_wide, and K1 / K2 calls per train step
# with bwd_wide or tail mode "1"
WIDE_FWD_K1, WIDE_TRAIN_SEGMENTS, TAIL1_SEGMENTS = 60, 56, 49
K1_RTOL = K1_ATOL = 0.02
SEG_ATOL = 1e-2
# the train step: batch, steps on one batch, heads
TRAIN_BATCH = 16
TRAIN_STEPS = 10
HEADS = ("seg", "bound", "dist", "color")
# K2, K3 and K4 against their plain versions (check_close): a bf16 result
# (K2's dx; K3's and K4's y and dx) within one bf16 ulp (2^-7 relative)
# plus 1e-3 of its largest magnitude; the f32 ones (dW, dbias and what K2's
# BN sums fold into) within 1e-3 of their largest magnitude (f32 sums over
# up to 10^6 pixels in another order)
BF16_ULP = 2 ** -7
ATOL_OF_MAX = 1e-3
# non-tensor-core peak (the 67 TFLOP/s f32 figure of the same data sheet),
# the rate the integer work of the label kernels is held against
PEAK_SCALAR_OPS = 67e12
# the 64 px, bs 2, f32 step, card (TF32 off) against the CPU plain path, at
# the limits of tests/test_torch_train.py: losses 2e-3 relative, every
# gradient at once 0.1 relative L2, each head leaf 3e-2, each BN running
# buffer 5e-3 relative L2 with the 1e-6 floor of the gradients (rel_l2):
# the BNs fed by a BN's output have a batch mean of 0 plus noise (running
# means of norm ~1e-9), which one CPU thread against eight already moves by
# 100%+. The heads get their gradients before any segment in the backward
# and the BN statistics come from the forward, so none of those sees K2:
# each leaf of the last decoder ResBlock (C = 32, eight fused segments:
# conv weights and biases from K2's dW and dc, BN scales and offsets from
# its S1 and S2) is held on its own, within 0.1 relative L2: 1.6x the
# card's reading on the dense trunk (0.061 on an H100; 0.048 in the NHWC
# routing) and 2.4x what the CPU alone shows between one thread and eight
# (0.042); a K2 that dropped dW reads 1. Each leaf of Combine_5 and
# PSPPooling_1, whose conv weights come straight from K3's and K4's dW
# after the heads, within 0.06: twice the card's reading (0.0305) and 2.6x
# the CPU's one thread against eight (0.0229); a K3 or K4 whose dW is 10%
# off reads 0.1 there, a K4 whose dx is zero 0.095 (the conv biases feed
# a BN, so their gradient is 0 and cannot show dbias: the k3 and k4 phases
# hold it)
STEP_TOL = {"loss_rel": 2e-3, "grads_rel_l2": 0.1, "heads_rel_l2": 3e-2,
            "bn_running_rel_l2": 5e-3, "last_block_rel_l2": 0.1,
            "dense_tail_rel_l2": 0.06}
HEAD_LEAVES = ("seg1", "seg2", "seg3", "Conv_6", "Conv_7", "Conv_9",
               "Conv_10", "Conv_11")
LAST_BLOCK = "ResBlockA_10"
# the leaves K3's and K4's backward feed straight after the heads
DENSE_TAIL = ("Combine_5", "PSPPooling_1")
# K3's 12 calls on a dense-trunk train step at patch P: (name, parts as
# (cin, input H = W, act, ups, stride), cout); K4's: (name, C, H, cout, k),
# one a pooled PSP level (2 and 4 from 128 px, 8 from 256 px; the levels
# follow the model's img_size, models/resuneta.py PSPPooling)
def psp_pooled(P):
    return [2] + ([4] if P >= 128 else []) + ([8] if P >= 256 else [])


def k3_calls(P):
    levels = [1] + psp_pooled(P)
    return (
        ("Conv_1 s2", ((32, P, False, 1, 2),), 64),
        ("Conv_2 s2", ((64, P // 2, False, 1, 2),), 128),
        ("Conv_3 s2", ((128, P // 4, False, 1, 2),), 256),
        ("UpSampleConv_2", ((256, P // 8, False, 1, 1),), 64),
        ("Combine_2", ((64, P // 8, True, 2, 1), (128, P // 4, False, 1, 1)),
         128),
        ("UpSampleConv_3", ((128, P // 4, False, 1, 1),), 32),
        ("Combine_3", ((32, P // 4, True, 2, 1), (64, P // 2, False, 1, 1)),
         64),
        ("UpSampleConv_4", ((64, P // 2, False, 1, 1),), 16),
        ("Combine_4", ((16, P // 2, True, 2, 1), (32, P, False, 1, 1)), 32),
        ("Combine_5", ((32, P, True, 1, 1), (32, P, False, 1, 1)), 32),
        ("PSPPooling_1 level 1", ((32, P, False, 1, 1),), 8),
        ("PSPPooling_1 projection",
         tuple((8, P // k, False, k, 1) for k in levels) +
         ((32, P, False, 1, 1),), 32),
    )


def k4_calls(P):
    return tuple((f"PSPPooling_1 level {k}", 32, P, 8, k)
                 for k in psp_pooled(P))


K3_CALLS = k3_calls(PATCH)
K4_CALLS = k4_calls(PATCH)
# the bf16 K3 calls with an upsampled part: their backward is four launches
K3_UPS_CALLS = sum(any(p[3] > 1 for p in parts) for _, parts, _ in K3_CALLS)
TOLERANCE = (f"bf16 results: |err| <= {ATOL_OF_MAX}*max|plain| + "
             f"{BF16_ULP}*|plain|; f32 ones: {ATOL_OF_MAX}*max|plain|")
NHWC_STEPS = 3
PROFILE_STEPS = 3      # the train phase's steps under torch.profiler


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build(build):
    t0 = time.time()
    logs = build.build_all()
    secs = time.time() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(secs, 3),
          "libraries": sorted(logs), "ptxas": ptxas, "nvidia_smi": smi})
    return smi


def check_close(name, got, want):
    """got against want within ATOL_OF_MAX of want's largest magnitude,
    plus one ulp of a bf16 result; returns the largest absolute error."""
    rtol = BF16_ULP if got.dtype == torch.bfloat16 else 0
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = ATOL_OF_MAX * want.abs().max() + rtol * want.abs()
    if not torch.isfinite(got).all() or not bool(torch.all(err <= lim)):
        fail(f"{name} disagrees with its plain version: max abs err "
             f"{err.max().item()}")
    return err.max().item()


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time (ms) the card could take at `peak` operations a
    second, and what bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def k1_bound(N, H, W, C, itemsize=2):
    flops = 2 * 9 * C * C * H * W * N
    nbytes = 2 * N * H * W * C * itemsize + 9 * C * C * 4 + 4 * C * 4
    return (*bound(flops, nbytes), flops, nbytes)


def phase_k1(convseg, F):
    """K1 at the inference path's shapes (on_path) and at the wide tier's
    (WIDE_LEVELS, `path` names the phase that runs them)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    shapes = [(C, S, BATCH, d, "slice") for C, S, ds in K1_LEVELS
              for d in ds] + [(C, S, N, d, path) for C, S, N, ds, path
                              in WIDE_LEVELS for d in ds]
    for C, S, N, d, path in shapes:
        on_path = path == "slice"
        x = torch.randn((N, S, S, C), generator=g, device="cuda").to(
            torch.bfloat16)
        a = torch.rand(C, generator=g, device="cuda") + 0.5
        b = torch.randn(C, generator=g, device="cuda") * 0.2
        w = torch.randn((3, 3, C, C), generator=g, device="cuda") / \
            (3.0 * C ** 0.5)
        bias = torch.randn(C, generator=g, device="cuda") * 0.1

        got = convseg.bn_act_conv(x, a, b, w, bias, dilation=d)
        want = convseg.bn_act_conv_reference(x, a, b, w, bias, dilation=d)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = err.max().item()
        ok = bool(torch.all(err <= K1_ATOL + K1_RTOL * want.float().abs()))
        if not torch.isfinite(got.float()).all() or not ok:
            fail(f"K1 disagrees with its plain version at C={C} {S}x{S} "
                 f"d={d}: max abs err {max_err}")

        # library yardstick: one cuDNN bf16 conv of the same precomputed z
        z = torch.relu(x.float() * a + b).to(torch.bfloat16) \
            .permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bl = bias.to(torch.bfloat16)
        ms = cuda_ms(lambda: convseg.bn_act_conv(x, a, b, w, bias,
                                                 dilation=d), reps=10)
        lib_ms = cuda_ms(lambda: F.conv2d(z, wl, bl, padding=d, dilation=d),
                         reps=10)
        plain_ms = cuda_ms(lambda: convseg.bn_act_conv_reference(
            x, a, b, w, bias, dilation=d), reps=3, warmup=1)
        bound_ms, bound_by, flops, nbytes = k1_bound(N, S, S, C)
        row = {"phase": "k1", "N": N, "H": S, "W": S, "C": C, "d": d,
               "on_path": on_path, "path": path,
               "design": convseg.K1_DESIGN,
               "work_item": list(convseg.K1_ITEMS[C]), "max_abs_err": max_err,
               "tolerance": f"|err| <= {K1_ATOL} + {K1_RTOL}*|plain|",
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               # 2 segments per dilation, in the encoder and decoder block
               "launches_per_forward": 4 if on_path else 0,
               "launches_per_unit": 4}
        emit(row)
        rows.append(row)
        del x, got, want, z, err
    return rows


def phase_slice(models, sliding, convseg, smi, fwd_wide=False):
    """Serving: the scene through predict_scene, K1 launches per batch (44,
    or WIDE_FWD_K1 with fwd_wide), the ids, a warm pass, and one patch's
    seg probabilities of the f32 model, card against the CPU plain path."""
    rng = np.random.default_rng(SEED)
    scene = rng.integers(0, 256, (SCENE, SCENE, 3), dtype=np.uint8)
    per_batch = WIDE_FWD_K1 if fwd_wide else 44
    model = models.ResUnetA(NUM_CLASSES, img_size=PATCH, multitasking=True,
                            dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(SEED),
                            fwd_wide=fwd_wide)
    n_params = sum(p.numel() for p in model.parameters())
    ids_fn = sliding.make_seg_ids_fn(model, norm_type=1)

    convseg.LAUNCHES = 0
    t0 = time.time()
    cmap, ids = sliding.predict_scene(ids_fn, scene, PATCH,
                                      batch_size=BATCH, ids_only=True)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = convseg.LAUNCHES
    n_batches = math.ceil((SCENE // PATCH) ** 2 / BATCH)
    if launches != per_batch * n_batches:
        fail(f"K1 launched {launches} times, expected "
             f"{per_batch * n_batches}")
    if cmap.shape != (SCENE, SCENE) or ids.dtype != np.uint8 or \
            int(ids.max()) >= NUM_CLASSES:
        fail(f"bad ids: {cmap.shape} {ids.dtype} max {ids.max()}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cmap2, _ = sliding.predict_scene(ids_fn, scene, PATCH,
                                     batch_size=BATCH, ids_only=True)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    repeat = float(np.mean(cmap == cmap2))
    if repeat < 0.999:
        fail(f"a second pass over the same scene gave other ids: {repeat}")

    # one patch's seg probabilities: f32 model, card against the CPU plain
    # path, the same weights, TF32 off (K1 still rounds z and w to bf16)
    m32 = models.ResUnetA(NUM_CLASSES, img_size=PATCH, multitasking=True,
                          dtype=torch.float32,
                          generator=torch.Generator().manual_seed(SEED),
                          device="cpu", fwd_wide=fwd_wide)
    patch = scene[None, :PATCH, :PATCH]
    x = torch.from_numpy(patch).float() / 255.0
    with torch.inference_mode():
        cpu_seg = m32(x)["seg"]
        with convseg.no_tf32():
            m32.to("cuda")
            gpu_seg = m32(x.to("cuda"))["seg"].cpu()
    err = (gpu_seg - cpu_seg).abs().max().item()
    top2 = torch.sort(cpu_seg, dim=-1).values[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > SEG_ATOL
    same = gpu_seg.argmax(-1) == cpu_seg.argmax(-1)
    agree = same[decided].float().mean().item() if decided.any() else 0.0
    if not torch.isfinite(gpu_seg).all() or err > SEG_ATOL or agree < 0.999:
        fail(f"card vs CPU seg probabilities: max abs err {err}, argmax "
             f"agreement {agree} on decided pixels")

    row = {"phase": "slice_wide" if fwd_wide else "slice",
           "model": "ResUnetA d6 multitask", "fwd_wide": fwd_wide,
           "params": n_params, "patch": PATCH, "batch": BATCH,
           "dtype": "bfloat16", "scene": [SCENE, SCENE],
           "patches": (SCENE // PATCH) ** 2, "batches": n_batches,
           "k1_launches": launches, "first_pass_s": first_s,
           "warm_pass_s": warm_s, "ids_repeat_share": repeat,
           "warm_mpix_per_s": SCENE * SCENE / warm_s / 1e6,
           "max_memory_allocated_bytes": peak,
           "seg_f32_card_vs_cpu_max_abs_err": err,
           "seg_tolerance": SEG_ATOL,
           "seg_argmax_agreement_decided": agree,
           "decided_share": decided.float().mean().item(),
           "class_histogram": np.bincount(cmap.ravel(),
                                          minlength=NUM_CLASSES).tolist(),
           "card": smi}
    emit(row)
    return row


def k2_bound(N, H, W, C):
    """dgrad + wgrad: 4*9*C^2 flops a pixel; x, g read and dx written in
    bf16, w read in bf16 and dW written in f32, the (3, C) sums."""
    flops = 4 * 9 * C * C * H * W * N
    nbytes = 3 * N * H * W * C * 2 + 9 * C * C * (2 + 4) + 7 * C * 4
    return (*bound(flops, nbytes), flops, nbytes)


# K2's shapes beside the 11 of the 256 px step: K9's (WIDE_LEVELS' train
# rows) and the dense tail's head segments without the ReLU (seg1, Conv_6,
# Conv_8: C = 32 at 256^2, d = 1, 3 calls a step); (C, H=W, batch, d, act,
# path, calls a step)
K2_SHAPES = tuple((C, S, TRAIN_BATCH, d, True, "train", 4)
                  for C, S, ds in K1_LEVELS for d in ds) + \
    tuple((C, S, N, d, True, path, 4) for C, S, N, ds, path in WIDE_LEVELS
          if path.startswith("train") for d in ds) + \
    ((32, PATCH, TRAIN_BATCH, 1, False, "train_tail1", 3),)


def segment_inputs(g, N, S, C):
    """Random bf16 x and g, BN parameters and statistics, and taps of one
    train segment on the card."""
    x = torch.randn((N, S, S, C), generator=g, device="cuda").to(
        torch.bfloat16)
    gr = torch.randn((N, S, S, C), generator=g, device="cuda").to(
        torch.bfloat16)
    gamma = torch.rand(C, generator=g, device="cuda") + 0.5
    beta = torch.randn(C, generator=g, device="cuda") * 0.2
    mean = torch.randn(C, generator=g, device="cuda") * 0.1
    var = torch.rand(C, generator=g, device="cuda") + 0.5
    w = torch.randn((3, 3, C, C), generator=g, device="cuda") / \
        (3.0 * C ** 0.5)
    return x, gr, gamma, beta, mean, var, w


def phase_k2(convseg):
    """K2 at the 256 px step's 11 shapes, K9 (C = 256) at the wide tier's
    train shapes and K2 without the ReLU (K2_SHAPES): the seven cotangents
    against the plain version; the kernel, the plain version and one cuDNN
    convolution_backward of the same precomputed bf16 z and g timed."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for C, S, N, d, act, path, calls in K2_SHAPES:
        x, gr, gamma, beta, mean, var, w = segment_inputs(g, N, S, C)
        a, b, invstd = convseg.segment_affine(gamma, beta, mean, var)
        args = (x, gr, a, b, mean, invstd, w)

        # the seven cotangents (dx, dgamma, dbeta, dmean, dvar, dW, dbias)
        got = convseg.fold_cotangents(
            *convseg.segment_bwd(*args, dilation=d, act=act), gamma, invstd)
        want = convseg.fold_cotangents(
            *convseg.segment_bwd_reference(*args, dilation=d, act=act),
            gamma, invstd)
        torch.cuda.synchronize()
        max_err = max(check_close(
            f"K2 output {k} at C={C} {S}x{S} d={d} act={act}", gt, wt)
            for k, (gt, wt) in enumerate(zip(got, want)))

        # library yardstick: cuDNN's dgrad + wgrad + bias of the same
        # precomputed bf16 z and g (no BN sums, no mask, no dx scaling)
        z = x.float() * a + b
        z = (torch.relu(z) if act else z).to(torch.bfloat16) \
            .permute(0, 3, 1, 2)
        gl = gr.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        ms = cuda_ms(lambda: convseg.segment_bwd(*args, dilation=d,
                                                 act=act), reps=10)
        lib_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            gl, z, wl, [C], [1, 1], [d, d], [d, d], False, [0, 0], 1,
            [True, True, True]), reps=10)
        plain_ms = cuda_ms(lambda: convseg.segment_bwd_reference(
            *args, dilation=d, act=act), reps=3, warmup=1)
        bound_ms, bound_by, flops, nbytes = k2_bound(N, S, S, C)
        row = {"phase": "k2", "N": N, "H": S, "W": S, "C": C, "d": d,
               "act": act, "path": path,
               "kernel": "K9" if C > 128 else "K2",
               "design": convseg.k2_design(C),
               "max_abs_err": max_err,
               "tolerance": TOLERANCE,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "calls_per_step": calls}
        emit(row)
        rows.append(row)
        del x, gr, got, want, z, gl
    return rows


def phase_k10(convseg, F):
    """K10, the mode-"2" segment (FusedSegmentBwdOnly: a plain forward,
    K2 backward), at the 11 shapes of the 256 px step, batch 16: the output
    and the seven gradients through autograd against the plain version
    (the same forward, K2's plain version), at check_close's limits. Times
    the forward + K2, the forward + K2's plain version, and cuDNN's conv
    and convolution_backward of a precomputed bf16 z (library_ms); the
    bound is K1's plus K2's."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rows = []
    for C, S, N, d, act, path, calls in K2_SHAPES:
        if path != "train":
            continue
        x, gr, gamma, beta, mean, var, w = segment_inputs(g, N, S, C)
        bias = torch.randn(C, generator=g, device="cuda") * 0.1

        # y and the seven gradients through autograd
        leaves = [t.detach().clone().requires_grad_() for t in
                  (x, gamma, beta, mean, var, w, bias)]
        y = convseg.fused_segment(*leaves, dilation=d, bwd_only=True)
        got = [y] + list(torch.autograd.grad(y, leaves, gr))
        torch.cuda.synchronize()
        a, b, invstd = convseg.segment_affine(gamma, beta, mean, var)
        want = [convseg.bwdonly_forward(x, a, b, w, bias, dilation=d),
                *convseg.fold_cotangents(*convseg.segment_bwd_reference(
                    x, gr, a, b, mean, invstd, w, dilation=d), gamma,
                    invstd)]
        max_err = max(check_close(f"K10 output {k} at C={C} {S}x{S} d={d}",
                                  gt, wt)
                      for k, (gt, wt) in enumerate(zip(got, want)))

        z = torch.relu(x.float() * a + b).to(torch.bfloat16) \
            .permute(0, 3, 1, 2)
        gl = gr.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bl = bias.to(torch.bfloat16)
        args = (x, gr, a, b, mean, invstd, w)
        ms = cuda_ms(lambda: (convseg.bwdonly_forward(x, a, b, w, bias,
                                                      dilation=d),
                              convseg.segment_bwd(*args, dilation=d)),
                     reps=10)
        lib_ms = cuda_ms(lambda: (
            F.conv2d(z, wl, bl, padding=d, dilation=d),
            torch.ops.aten.convolution_backward(
                gl, z, wl, [C], [1, 1], [d, d], [d, d], False, [0, 0], 1,
                [True, True, True])), reps=10)
        plain_ms = cuda_ms(lambda: (
            convseg.bwdonly_forward(x, a, b, w, bias, dilation=d),
            convseg.segment_bwd_reference(*args, dilation=d)),
            reps=3, warmup=1)
        b1, _, f1, n1 = k1_bound(N, S, S, C)
        b2, _, f2, n2 = k2_bound(N, S, S, C)
        bound_ms, bound_by = bound(f1 + f2, n1 + n2)
        row = {"phase": "k10", "N": N, "H": S, "W": S, "C": C, "d": d,
               "max_abs_err": max_err, "tolerance": TOLERANCE,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "cuDNN conv + convolution_backward of a "
                          "precomputed bf16 z (no BN sums)",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": (f1 + f2) / 1e9, "mbytes": (n1 + n2) / 1e6,
               "calls_per_step": calls}
        emit(row)
        rows.append(row)
        del x, gr, got, want, z, gl, leaves, y
    return rows


def k3_work(parts, cout, N, H, itemsize=2):
    """(fwd flops, fwd bytes, bwd flops, bwd bytes) of one K3 call at
    output H x H, in bf16 (itemsize 2) or f32 (4): each input element the
    function needs read once (a strided part's read pixels only, but its dx
    written in full), each output written once, W in the compute type, dW
    and the sums in f32. An upsampled part's product is counted at its own
    resolution."""
    flops = nread = nfull = 0
    for cin, h, _, k, s in parts:
        pix = N * (H // k) ** 2 if s == 1 else N * H * H
        flops += 2 * pix * cin * cout
        nread += pix * cin
        nfull += N * h * h * cin
    cin_all = sum(p[0] for p in parts)
    out = N * H * H * cout
    w_bytes = cin_all * cout * itemsize
    fwd_bytes = (nread + out) * itemsize + w_bytes + cout * 4
    bwd_bytes = (nread + out + nfull) * itemsize + w_bytes + \
        (cin_all + 1) * cout * 4
    return flops, fwd_bytes, 2 * flops, bwd_bytes


def phase_k3(densemm, F, convseg, calls=K3_CALLS, N=TRAIN_BATCH,
             dtype=torch.bfloat16, phase="k3"):
    """K3's `calls` at batch N in `dtype` against the plain versions, each
    way timed beside the bound, the plain version and the library pair
    (in f32 with TF32 off: the same precision as the kernel's)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    f32 = dtype == torch.float32
    peak = PEAK_SCALAR_OPS if f32 else PEAK_BF16_FLOPS
    rows = []
    for name, parts, cout in calls:
        s0 = parts[0][4]
        H = parts[0][1] // s0 * parts[0][3]
        xs = [torch.randn((N, h, h, c), generator=g, device="cuda").to(
            dtype) for c, h, _, _, _ in parts]
        cin = sum(p[0] for p in parts)
        w = torch.randn((cin, cout), generator=g, device="cuda") / cin ** 0.5
        bias = torch.randn(cout, generator=g, device="cuda") * 0.1
        spec = {"acts": [p[2] for p in parts], "ups": [p[3] for p in parts],
                "strides": [p[4] for p in parts]}
        gr = torch.randn((N, H, H, cout), generator=g, device="cuda").to(
            dtype)

        y = densemm.dense_mm_fwd(xs, w, bias, **spec)
        got = densemm.dense_mm_bwd(xs, gr, w, **spec)
        torch.cuda.synchronize()
        err = check_close(f"K3 {name} y", y,
                          densemm.dense_mm_reference(xs, w, bias, **spec))
        want = densemm.dense_mm_bwd_reference(xs, gr, w, **spec)
        for p, (dx, wdx) in enumerate(zip(got[0], want[0])):
            err = max(err, check_close(f"K3 {name} dx_{p}", dx, wdx))
        for k, lab in ((1, "dW"), (2, "dbias")):
            err = max(err, check_close(f"K3 {name} {lab}", got[k], want[k]))

        # library yardstick: the concat and upsample materialised, then one
        # cuDNN 1x1 conv and its convolution_backward
        cat = torch.cat([
            densemm.upsample_nearest(torch.relu(x) if a else x, k)
            for x, (_, _, a, k, _) in zip(xs, parts)], dim=3).permute(
                0, 3, 1, 2)
        wl = w.t().to(dtype)[:, :, None, None].contiguous(
            memory_format=torch.channels_last)
        bl = bias.to(dtype)
        gl = gr.permute(0, 3, 1, 2)
        st = [s0, s0]
        fwd_ms = cuda_ms(lambda: densemm.dense_mm_fwd(xs, w, bias, **spec),
                         reps=10)
        bwd_ms = cuda_ms(lambda: densemm.dense_mm_bwd(xs, gr, w, **spec),
                         reps=10)
        with convseg.no_tf32():
            lib_fwd = cuda_ms(lambda: F.conv2d(cat, wl, bl, stride=s0),
                              reps=10)
            lib_bwd = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                gl, cat, wl, [cout], st, [0, 0], [1, 1], False, [0, 0], 1,
                [True, True, True]), reps=10)
        plain_fwd = cuda_ms(lambda: densemm.dense_mm_reference(
            xs, w, bias, **spec), reps=3, warmup=1)
        plain_bwd = cuda_ms(lambda: densemm.dense_mm_bwd_reference(
            xs, gr, w, **spec), reps=3, warmup=1)
        ff, fb, bf, bb = k3_work(parts, cout, N, H, 4 if f32 else 2)
        b_fwd, by_fwd = bound(ff, fb, peak)
        b_bwd, by_bwd = bound(bf, bb, peak)
        row = {"phase": phase, "call": name, "N": N, "H": H, "cout": cout,
               "dtype": str(dtype).removeprefix("torch."), "parts":
               [list(p) for p in parts], "peak_flops": peak,
               "design": densemm.k3_design(xs[0].dtype), "max_abs_err": err,
               "tolerance": TOLERANCE,
               "ms_fwd": fwd_ms, "ms_bwd": bwd_ms,
               "plain_ms_fwd": plain_fwd, "plain_ms_bwd": plain_bwd,
               "library_ms_fwd": lib_fwd, "library_ms_bwd": lib_bwd,
               "bound_ms_fwd": b_fwd, "bound_by_fwd": by_fwd,
               "bound_ms_bwd": b_bwd, "bound_by_bwd": by_bwd,
               "share_of_bound_fwd": b_fwd / fwd_ms,
               "share_of_bound_bwd": b_bwd / bwd_ms,
               "gflop": (ff + bf) / 1e9, "mbytes": (fb + bb) / 1e6,
               "calls_per_step": 1}
        emit(row)
        rows.append(row)
        del xs, y, got, want, cat, gl, gr
    return rows


def phase_k4(poolconv, F, convseg, calls=K4_CALLS, N=TRAIN_BATCH,
             dtype=torch.bfloat16, phase="k4"):
    """K4's `calls` at batch N in `dtype` against the plain versions, as
    phase_k3."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    f32 = dtype == torch.float32
    peak = PEAK_SCALAR_OPS if f32 else PEAK_BF16_FLOPS
    isz = 4 if f32 else 2
    rows = []
    for name, C, S, cout, k in calls:
        x = torch.randn((N, S, S, C), generator=g, device="cuda")
        # planted exact ties: half the channels on a grid of 1/4, so most
        # of their windows hold their max more than once
        x[..., :C // 2] = torch.round(x[..., :C // 2] * 4) / 4
        x = x.to(dtype)
        w = torch.randn((C, cout), generator=g, device="cuda") / C ** 0.5
        bias = torch.randn(cout, generator=g, device="cuda") * 0.1
        gr = torch.randn((N, S // k, S // k, cout), generator=g,
                         device="cuda").to(dtype)
        y = poolconv.pool_conv_fwd(x, w, bias, k=k)
        got = poolconv.pool_conv_bwd(x, gr, w, k=k)
        torch.cuda.synchronize()
        err = check_close(f"K4 k={k} y", y,
                          poolconv.pool_conv_reference(x, w, bias, k=k))
        want = poolconv.pool_conv_bwd_reference(x, gr, w, k=k)
        for i, lab in enumerate(("dx", "dW", "dbias")):
            err = max(err, check_close(f"K4 k={k} {lab}", got[i], want[i]))
        xw = x.float().reshape(N, S // k, k, S // k, k, C)
        tie_share = ((xw == xw.amax(dim=(2, 4), keepdim=True)).sum(
            dim=(2, 4)) > 1).float().mean().item()

        # library yardstick, two calls: F.max_pool2d, then the cuDNN 1x1
        # conv; backward: convolution_backward, then max_pool2d's (which
        # routes a tie to one element)
        xl = x.permute(0, 3, 1, 2)
        pooled, idx = F.max_pool2d(xl, k, return_indices=True)
        wl = w.t().to(dtype)[:, :, None, None].contiguous(
            memory_format=torch.channels_last)
        bl = bias.to(dtype)
        gl = gr.permute(0, 3, 1, 2)

        def lib_bwd_fn():
            dp, _, _ = torch.ops.aten.convolution_backward(
                gl, pooled, wl, [cout], [1, 1], [0, 0], [1, 1], False,
                [0, 0], 1, [True, True, True])
            torch.ops.aten.max_pool2d_with_indices_backward(
                dp, xl, [k, k], [k, k], [0, 0], [1, 1], False, idx)

        fwd_ms = cuda_ms(lambda: poolconv.pool_conv_fwd(x, w, bias, k=k),
                         reps=10)
        bwd_ms = cuda_ms(lambda: poolconv.pool_conv_bwd(x, gr, w, k=k),
                         reps=10)
        with convseg.no_tf32():
            lib_fwd = cuda_ms(lambda: F.conv2d(F.max_pool2d(xl, k), wl, bl),
                              reps=10)
            lib_bwd = cuda_ms(lib_bwd_fn, reps=10)
        plain_fwd = cuda_ms(lambda: poolconv.pool_conv_reference(
            x, w, bias, k=k), reps=3, warmup=1)
        plain_bwd = cuda_ms(lambda: poolconv.pool_conv_bwd_reference(
            x, gr, w, k=k), reps=3, warmup=1)
        Mo = N * (S // k) ** 2
        ff = 2 * Mo * C * cout
        xb = N * S * S * C * isz
        fb = xb + Mo * cout * isz + C * cout * isz + cout * 4
        bb = 2 * xb + Mo * cout * isz + C * cout * isz + (C + 1) * cout * 4
        b_fwd, by_fwd = bound(ff, fb, peak)
        b_bwd, by_bwd = bound(2 * ff, bb, peak)
        row = {"phase": phase, "call": name, "N": N, "H": S, "C": C,
               "cout": cout, "k": k, "dtype": str(dtype).removeprefix(
                   "torch."), "peak_flops": peak,
               "design": poolconv.K4_DESIGN,
               "tie_window_share": tie_share,
               "max_abs_err": err,
               "tolerance": TOLERANCE,
               "ms_fwd": fwd_ms, "ms_bwd": bwd_ms,
               "plain_ms_fwd": plain_fwd, "plain_ms_bwd": plain_bwd,
               "library_ms_fwd": lib_fwd, "library_ms_bwd": lib_bwd,
               "library": "two calls: F.max_pool2d, then a cuDNN 1x1 conv; "
                          "its backward routes a tie to one element",
               "bound_ms_fwd": b_fwd, "bound_by_fwd": by_fwd,
               "bound_ms_bwd": b_bwd, "bound_by_bwd": by_bwd,
               "share_of_bound_fwd": b_fwd / fwd_ms,
               "share_of_bound_bwd": b_bwd / bwd_ms,
               "gflop": 3 * ff / 1e9, "mbytes": (fb + bb) / 1e6,
               "calls_per_step": 1}
        emit(row)
        rows.append(row)
        del x, y, got, want, xl, pooled, idx, gl, gr
    return rows


def voronoi_ids(n, size, classes, rng, sites=12):
    """(n, size, size) class ids of blob regions: each pixel takes the class
    of its nearest random site."""
    yy, xx = np.mgrid[:size, :size]
    out = np.empty((n, size, size), np.uint8)
    for k in range(n):
        pts = rng.uniform(0, size, (sites, 2))
        cls = rng.integers(0, classes, sites)
        d2 = (yy[..., None] - pts[:, 0]) ** 2 + \
            (xx[..., None] - pts[:, 1]) ** 2
        out[k] = cls[np.argmin(d2, axis=-1)]
    return out


# the EDT's layouts timed beside its default on each train step's planes
# (distance.distance_transform_edt's arguments): every design and a tile
# of the banded passes it can be forced to (the cluster sizes and fused
# tails: tools/torch_edt_ablate.py)
EDT_LAYOUTS = {256: ({"design": "tail"}, {"design": "tail", "tile": 4}),
               512: ({"tile": 8},), 1024: ({"tile": 4},)}


# Canny's design (canny.cu): pass 1 a tiled stencil kernel, pass 2 the
# band kernel with the hysteresis, on planes pass 1 flagged
CANNY_DESIGN = "two_pass"


# class planes a train batch gives the label kernels, by patch: (Voronoi
# samples, classes, uniform-noise planes), beside an all-zero and an
# all-one plane (80 planes at 256^2 as at batch 16, 40 at 512^2 as at
# batch 8, 10 at 1024^2 as at batch 2, all ISPRS's 5 classes; 28 at 128^2,
# the 8 x 3 class planes of the Amazon step at batch 8 and 4 more)
LABEL_PLANES = {128: (8, 3, 2), 256: (14, 5, 8), 512: (6, 5, 8),
                1024: (1, 5, 3)}


def label_planes(size=PATCH):
    """int32 planes of size^2 (LABEL_PLANES): Voronoi blobs, uniform
    noise, an all-zero and an all-one plane."""
    samples, classes, noise = LABEL_PLANES[size]
    rng = np.random.default_rng(SEED + 5)
    ids = voronoi_ids(samples, size, classes, rng)
    blobs = np.eye(classes, dtype=np.int32)[ids].transpose(0, 3, 1, 2)
    planes = np.concatenate([
        blobs.reshape(-1, size, size),
        (rng.random((noise, size, size)) < 0.5).astype(np.int32),
        np.zeros((1, size, size), np.int32),
        np.ones((1, size, size), np.int32)])
    return torch.from_numpy(planes).cuda()


def phase_labels(distance, boundary, size=PATCH):
    """K5 and K6, bit for bit, on label_planes(size); rows "k5" and "k6",
    with the size after an underscore where it is not PATCH (the Amazon
    step's 128^2: the EDT's cluster of 2 blocks, no other check's
    layout). Bound (label_row): 4 bytes in and 4 out a
    pixel, and the integer work the function needs on these planes
    counted against PEAK_SCALAR_OPS: K5 ~100 operations per JFA pass for
    each pixel that is not its own seed (edt_ops), K6 ~50 a pixel (Sobel,
    NMS, thresholds, cross dilation; these class planes need no
    hysteresis round). The EDT's row names its design (distance.plan) and
    its launches a call."""
    planes = label_planes(size)
    H, W = planes.shape[1:]
    tag = "" if size == PATCH else f"_{size}"
    rows = {}
    for name, mod, fn, ref, ops in (
            ("k5", distance, distance.distance_transform_edt,
             distance.distance_transform_edt_reference,
             edt_ops(distance, planes)),
            ("k6", boundary, boundary.boundary_label,
             boundary.boundary_label_reference, 50 * planes.numel())):
        n0 = mod.LAUNCHES
        got = fn(planes)
        launches = mod.LAUNCHES - n0
        same(name, got, ref(planes))
        ms = cuda_ms(lambda: fn(planes), reps=10)
        plain_ms = cuda_ms(lambda: ref(planes), reps=2, warmup=1)
        row = {"phase": name + tag, **label_row(planes, ms, plain_ms, ops),
               "launches_per_call": launches}
        if name == "k5":
            layout = distance.plan(H, W)
            row.update(design=layout["design"], cluster_blocks=layout["cs"])
        else:
            row["design"] = CANNY_DESIGN
        emit(row)
        rows[name + tag] = row
    return rows


def edt_ops(distance, planes):
    """The integer operations the EDT needs on these planes: ~100 per JFA
    pass (8 candidates: bounds, the seed's unpacking, d^2, compare and
    select) for each nonzero pixel. A zero pixel is its own seed (d^2 0,
    nothing nearer) and needs none: the kernels skip it."""
    H, W = planes.shape[1:]
    return 100 * len(distance.tiled_steps(H, W)) * \
        int(torch.count_nonzero(planes))


def label_row(planes, ms, plain_ms, ops):
    """The fields of a label kernel's row; bound: 4 bytes in and 4 out a
    pixel against PEAK_BYTES, `ops` integer operations against
    PEAK_SCALAR_OPS."""
    P, H, W = planes.shape
    t_ops = ops / PEAK_SCALAR_OPS
    t_bytes = P * H * W * 8 / PEAK_BYTES
    return {"planes": P, "H": H, "W": W,
            "max_abs_err": 0.0, "tolerance": "bit-identical",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no PyTorch call computes this function",
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": max(t_ops, t_bytes) * 1e3 / ms,
            "ops": ops,
            "nonzero_share": int(torch.count_nonzero(planes)) /
            planes.numel()}


def same(name, got, *wants):
    torch.cuda.synchronize()
    for want in wants:
        if not torch.equal(got, want):
            fail(f"{name} differs from its plain version at "
                 f"{int((got != want).sum())} pixels")


def phase_labels_tiled(distance, boundary):
    """K8 bit for bit against its plain version (the same band
    decomposition, at the kernel's tile) and the whole-plane plain version,
    on the planes of the 512 px and 1024 px train steps (40 x 512^2 and
    10 x 1024^2); K8 forced through `tile` against K6 on the 80 planes of
    256^2. The EDT kernels (K5's planes and K7's alike) on the planes of
    all three steps, at their default layout against the plain version of
    K7's bands and the whole-plane plain version, and at every layout of
    EDT_LAYOUTS against the default (ms_by_design). Bounds as
    phase_labels' (the EDT edt_ops, K8 ~50 operations a pixel;
    K8's halo rows and the EDT tail's are recomputed work the bound does
    not count); plain_ms of the plain version at the tile the wrapper
    gives it on the CPU."""
    rows = {}
    p256 = label_planes(256)
    k8_tile = boundary.default_tile(256, 256)
    same("K8 (tile 128) against K6 at 256^2",
         boundary.boundary_label(p256, tile=k8_tile),
         boundary.boundary_label(p256))
    forced = {"k8_vs_k6_256": {"planes": p256.shape[0], "tile": k8_tile}}
    del p256

    for size in (512, 1024):
        planes = label_planes(size)
        H, W = planes.shape[1:]
        tile = boundary.default_tile(H, W)
        n0 = boundary.TILED_LAUNCHES
        got = boundary.boundary_label(planes)
        launches = boundary.TILED_LAUNCHES - n0
        same(f"K8 at {size}^2", got,
             boundary.boundary_label_tiled_reference(planes, tile),
             boundary.boundary_label_reference(planes))
        by_tile = {}
        for t in (32, 64, 128):
            same(f"K8 at {size}^2, tile {t}",
                 boundary.boundary_label(planes, tile=t), got)
            by_tile[t] = cuda_ms(lambda: boundary.boundary_label(
                planes, tile=t), reps=5)
        ms = cuda_ms(lambda: boundary.boundary_label(planes), reps=10)
        plain_ms = cuda_ms(lambda: boundary.boundary_label_tiled_reference(
            planes, tile), reps=2, warmup=1)
        windows = sum(min(H, r + tile + boundary.HALO) -
                      max(0, r - boundary.HALO) for r in range(0, H, tile))
        row = {"phase": "k8", **label_row(planes, ms, plain_ms,
                                          50 * planes.numel()),
               "design": CANNY_DESIGN, "launches_per_call": launches,
               "tile": tile, "ms_by_tile": by_tile,
               "recomputed_rows_share": windows / H}
        emit(row)
        rows[f"k8_{size}"] = row
        del planes, got

    for size, name in ((256, "k5_layouts_256"), (512, "k5_512"),
                       (1024, "k7")):
        planes = label_planes(size)
        H, W = planes.shape[1:]
        lay = distance.plan(H, W)
        n0 = distance.LAUNCHES
        got = distance.distance_transform_edt(planes)
        launches = distance.LAUNCHES - n0
        same(f"the EDT at {size}^2", got,
             distance.distance_transform_edt_tiled_reference(
                 planes, distance.default_tile(W)),
             distance.distance_transform_edt_reference(planes))
        by_design = {}
        for kw in EDT_LAYOUTS[size]:
            def fn(kw=kw):
                return distance.distance_transform_edt(planes, **kw)
            same(f"the EDT at {size}^2, {kw}", fn(), got)
            by_design[json.dumps(kw, sort_keys=True)] = cuda_ms(fn, reps=5)
        row = {"phase": name, "design": lay["design"],
               "tile": lay["tile"], "cluster": lay["cs"],
               "fused_steps": lay["steps"][lay["nbanded"]:],
               "launches_per_call": launches, "ms_by_design": by_design}
        if size > 256:        # phase_labels times 256^2
            ms = cuda_ms(lambda: distance.distance_transform_edt(planes),
                         reps=10)
            plain_ms = cuda_ms(
                lambda: distance.distance_transform_edt_tiled_reference(
                    planes, distance.PLAIN_TILE), reps=2, warmup=1)
            row.update(label_row(planes, ms, plain_ms,
                                 edt_ops(distance, planes)),
                       plain_tile=distance.PLAIN_TILE)
        emit(row)
        rows[name] = row
        del planes, got
    forced["edt_layouts_vs_plain_256"] = {
        "planes": 80, "layouts": list(rows["k5_layouts_256"]["ms_by_design"])}
    emit({"phase": "k7_k8_forced_256", **forced, "max_abs_err": 0.0})
    return rows


def rel_l2(a, b, atol=1e-6):
    """Relative L2 with an absolute floor (tests/test_train_parity.py:
    113-120): a conv bias straight before a BN has a zero gradient, and
    both sides give noise there."""
    d = (a - b).norm().item()
    return 0.0 if d <= atol else d / max(b.norm().item(), 1e-12)


def step_64px(device, raw, amazon=False, remat=False, **modes):
    """One 64 px, bs 2, f32 dense-trunk train step from seeded weights on
    `device`, in the opt-in `modes` (ResUnetA arguments): the ISPRS step
    (5 classes, Tanimoto on the four heads, make_device_pipeline on uint8
    patches) or with `amazon` the Amazon CLI's (14 bands, 3 classes, no
    colour head, the WCE on seg, bound and dist, make_label_head_pipeline
    on float patches and a one-hot). Returns the metrics row, every
    parameter's gradient and every BN running buffer, in f64 on the
    CPU. `remat` rematerialises the ISPRS step."""
    from resuneta_torch import losses, models
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.train import create_train_state, make_train_step

    gen = torch.Generator().manual_seed(SEED + 7)
    if amazon:
        model, state, step = amazon_step(device, 64, gen, **modes)
    else:
        model = models.ResUnetA(NUM_CLASSES, img_size=64,
                                dtype=torch.float32, generator=gen,
                                device=device, dense_trunk=True, **modes)
        state = create_train_state(model, "adam", 1e-4)
        step = make_train_step(
            losses.make_losses("tanimoto"), {h: 1.0 for h in HEADS}, True,
            preprocess=make_device_pipeline(NUM_CLASSES, 1, device=device),
            device=device, remat=remat)
    _, row = step(state, raw)
    grads = {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()}
    bufs = {k: v.detach().cpu().double() for k, v in model.named_buffers()}
    return row.cpu().double(), grads, bufs


def amazon_step(device, patch, gen, **modes):
    """The Amazon CLI's f32 dense-trunk model (14 bands, 3 classes, no
    colour head) at `patch` from `gen`'s weights, its Adam state and its
    train step: the WCE on seg, bound and dist through
    make_label_head_pipeline on float patches and a one-hot."""
    from resuneta_torch import losses, models
    from resuneta_torch.data import make_label_head_pipeline
    from resuneta_torch.train import create_train_state, make_train_step

    model = models.ResUnetA(AMAZON_CLASSES, img_size=patch, color_head=False,
                            in_channels=AMAZON_BANDS, dtype=torch.float32,
                            generator=gen, device=device, dense_trunk=True,
                            **modes)
    wce = losses.weighted_categorical_crossentropy(AMAZON_WCE)
    step = make_train_step({h: wce for h in AMAZON_HEADS},
                           {h: 1.0 for h in AMAZON_HEADS}, True,
                           preprocess=make_label_head_pipeline(device),
                           device=device)
    return model, create_train_state(model, "adam", 1e-4), step


def amazon_batch(batch, patch, rng):
    """A float Amazon batch: standard-normal bands and a one-hot of
    Voronoi class regions."""
    ids = voronoi_ids(batch, patch, AMAZON_CLASSES, rng)
    return {"image": rng.standard_normal(
                (batch, patch, patch, AMAZON_BANDS)).astype(np.float32),
            "seg": np.eye(AMAZON_CLASSES, dtype=np.float32)[ids]}


def step_errors(got, want, heads=HEAD_LEAVES, last_block=LAST_BLOCK,
                dense_tail=DENSE_TAIL, n_losses=5):
    """The readings STEP_TOL holds, of one 64 px step against another;
    `heads`, `last_block` and `dense_tail` name the model's leaves (the d6
    by default; dense_tail None for a model without it), the row's first
    `n_losses` entries are its losses (5 multitask, 1 single-task)."""
    (rg, gg, bg), (rw, gw, bw) = got, want
    n = n_losses
    a = torch.cat([g.ravel() for g in gg.values()])
    b = torch.cat([g.ravel() for g in gw.values()])
    # the losses the step has: the Amazon step's colour loss is 0 on both
    # sides (no colour head), and a loss 0 on one side only reads inf
    have = rw[:n] != 0
    loss_rel = ((rg[:n] - rw[:n]).abs()[have] / rw[:n][have].abs()).max()
    if (rg[:n][~have] != 0).any():
        loss_rel = torch.tensor(float("inf"))
    return {
        "loss_rel": loss_rel.item(),
        "grads_rel_l2": rel_l2(a, b, atol=0),
        "heads_rel_l2": max(rel_l2(gg[k], gw[k]) for k in gw
                            if k.split(".")[0] in heads),
        "last_block_rel_l2": max(rel_l2(gg[k], gw[k]) for k in gw
                                 if k.startswith(last_block + ".")),
        **({"dense_tail_rel_l2": max(rel_l2(gg[k], gw[k]) for k in gw
                                     if k.split(".")[0] in dense_tail)}
           if dense_tail else {}),
        "bn_running_rel_l2": max(rel_l2(bg[k], bw[k]) for k in bw)}


def step_card_vs_cpu(threads=True, amazon=False, remat=False, **modes):
    """The 64 px, bs 2, f32 dense-trunk step (step_64px: ISPRS, or the
    Amazon CLI's with `amazon`, in the opt-in `modes`) on the card (TF32
    off) against the CPU plain path, from the same weights and batch, and
    (with `threads`) the CPU with one thread against the CPU with many,
    the same readings of the order of sums alone. Returns the readings,
    the kernel launches of the card's step, and the names of the readings
    past STEP_TOL."""
    from resuneta_torch.ops import (boundary, convseg, densemm, distance,
                                    poolconv)

    rng = np.random.default_rng(SEED + 4)
    if amazon:
        raw = amazon_batch(2, 64, rng)
    else:
        raw = {"image_u8": rng.integers(0, 256, (2, 64, 64, 3),
                                        dtype=np.uint8),
               "label_ids": voronoi_ids(2, 64, NUM_CLASSES, rng),
               "aug": np.array([0, 3])}
    cpu = step_64px("cpu", raw, amazon, remat, **modes)
    out = {}
    if threads:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cpu1 = step_64px("cpu", raw, amazon, remat, **modes)
        finally:
            torch.set_num_threads(n)
        out[f"cpu_1_vs_{n}_threads"] = step_errors(cpu1, cpu)
    counters = ((convseg, "LAUNCHES"), (convseg, "BWD_LAUNCHES"),
                (densemm, "LAUNCHES"), (densemm, "BWD_LAUNCHES"),
                (poolconv, "LAUNCHES"), (poolconv, "BWD_LAUNCHES"),
                (distance, "LAUNCHES"), (boundary, "LAUNCHES"),
                (convseg, "WIDE_BWD_LAUNCHES"),
                (convseg, "BWDONLY_LAUNCHES"))
    before = [getattr(m, k) for m, k in counters]
    with convseg.no_tf32():
        card = step_64px("cuda", raw, amazon, remat, **modes)
    torch.cuda.synchronize()
    launches = dict(zip(("K1", "K2", "K3", "K3_bwd", "K4", "K4_bwd",
                         "K5/K7", "K6", "K9", "K10"),
                        (getattr(m, k) - c for (m, k), c in
                         zip(counters, before))))
    errs = step_errors(card, cpu)
    return {"modes": modes, "amazon": amazon, "remat": remat,
            "card_vs_cpu": errs, **out,
            "tolerance": STEP_TOL, "launches": launches,
            "failed": [k for k, v in errs.items() if not v < STEP_TOL[k]]}


def kernel_counters(mods):
    """{name: (module, attribute)} of every kernel's launch and call count
    on the train paths; mods = (convseg, densemm, poolconv, distance,
    boundary)."""
    convseg, densemm, poolconv, distance, boundary = mods
    return {"K1": (convseg, "LAUNCHES"), "K2": (convseg, "BWD_LAUNCHES"),
            "K2 calls": (convseg, "BWD_CALLS"),
            "K3": (densemm, "LAUNCHES"), "K3 calls": (densemm, "CALLS"),
            "K3 bwd": (densemm, "BWD_LAUNCHES"),
            "K3 bwd calls": (densemm, "BWD_CALLS"),
            "K4": (poolconv, "LAUNCHES"), "K4 calls": (poolconv, "CALLS"),
            "K4 bwd": (poolconv, "BWD_LAUNCHES"),
            "K4 bwd calls": (poolconv, "BWD_CALLS"),
            "K5/K7": (distance, "LAUNCHES"),
            "K6": (boundary, "LAUNCHES"),
            "K8": (boundary, "TILED_LAUNCHES"),
            "K9": (convseg, "WIDE_BWD_LAUNCHES"),
            "K10": (convseg, "BWDONLY_LAUNCHES")}


def train_steps(models, steps, dense_trunk, mods, patch=PATCH,
                batch=TRAIN_BATCH, remat=False, profile=None, **modes):
    """`steps` ISPRS train steps at full width from seeded weights, in the
    opt-in `modes` (ResUnetA arguments), rematerialised with `remat`,
    every kernel count set to 0 just before and read just after. Returns
    (the launches and calls by kernel, metric rows, step times, peak
    memory after the first step, params). With a dict `profile`,
    PROFILE_STEPS more steps after the counts are read, under
    torch.profiler (utils/xprof.py): their device ms a step and wall ms a
    step go into it."""
    from resuneta_torch import losses
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED + 3)
    raw = {"image_u8": rng.integers(0, 256, (batch, patch, patch, 3),
                                    dtype=np.uint8),
           "label_ids": voronoi_ids(batch, patch, NUM_CLASSES, rng),
           "aug": rng.integers(0, 5, batch)}
    model = models.ResUnetA(NUM_CLASSES, img_size=patch, multitasking=True,
                            dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(SEED),
                            dense_trunk=dense_trunk, **modes)
    state = create_train_state(model, "adam", 1e-4)
    step = make_train_step(losses.make_losses("tanimoto"),
                           {h: 1.0 for h in HEADS}, True,
                           preprocess=make_device_pipeline(NUM_CLASSES, 1),
                           remat=remat)
    counters = kernel_counters(mods)
    for m, k in counters.values():
        setattr(m, k, 0)
    rows, times = [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        state, row = step(state, raw)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        rows.append(row.cpu().numpy())
    counts = {name: getattr(m, k) for name, (m, k) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    rows = np.stack(rows)
    if not np.isfinite(rows).all():
        fail(f"non-finite metric rows: {rows}")
    if profile is not None:
        from resuneta_torch.utils import xprof

        t0 = time.time()
        profile["device_ms_per_step"] = xprof.capture_device_ms(
            lambda: step(state, raw), PROFILE_STEPS, torch.cuda.synchronize)
        profile["profiled_wall_ms_per_step"] = \
            (time.time() - t0) * 1e3 / PROFILE_STEPS
    return (counts, rows, times, peak,
            sum(p.numel() for p in model.parameters()))


# the label kernels' launches per step by patch: one EDT call (256^2:
# the whole plane in one cluster launch; 512^2 and 1024^2: the leading
# pass and the steps above 4 banded, 7 and 8 launches, and one fused
# tail; the reference gives 256^2 and 512^2 planes to K5, larger ones to
# K7, the port all to jfa.cu) and one Canny call of 2 launches, pass 1 and
# pass 2 (boundary.PASSES; K6 up to 384^2, K8 above) over all the batch's
# class planes
LABEL_LAUNCHES = {64: {"K5/K7": 1, "K6": 2, "K8": 0},
                  128: {"K5/K7": 1, "K6": 2, "K8": 0},
                  256: {"K5/K7": 1, "K6": 2, "K8": 0},
                  512: {"K5/K7": 8, "K6": 0, "K8": 2},
                  1024: {"K5/K7": 9, "K6": 0, "K8": 2}}


def expected_counts(steps, dense, patch=PATCH, segments=44, k1=True,
                    wide=0, bwd_only=False, f32=False, remat=False):
    """Per step: `segments` fused segments, each one K1 launch forward
    (none with k1=False: segment mode "2") and one K2 call (4 launches)
    backward, `wide` of them at C = 256 (K9), all of them from
    FusedSegmentBwdOnly's backward (K10) with bwd_only; on the dense
    trunk's tail 12 K3 calls and a K4 call a pooled PSP level (psp_pooled:
    3 at 256 px and up, 2 at 128 px) each way (K3: one launch forward,
    three backward, and in bf16 a fourth before the backward of each K3
    call with an upsampled part: K3_UPS_CALLS of them; K4: one forward,
    two backward); LABEL_LAUNCHES. With remat (make_train_step(remat=
    True)) the checkpointed blocks' forwards run again in the backward:
    every K1 launch, the 9 K3 calls past the three stride-2 convs and
    every K4 forward once more."""
    k3, k4 = (12, len(psp_pooled(patch))) if dense else (0, 0)
    k3_bwd = 3 * k3 + (K3_UPS_CALLS if dense and not f32 else 0)
    again = 2 if remat else 1
    k3_fwd = k3 + (k3 - 3 if remat and dense else 0)
    per = {"K1": again * segments if k1 else 0, "K2": 4 * segments,
           "K2 calls": segments, "K3": k3_fwd,
           "K3 calls": k3_fwd, "K3 bwd": k3_bwd, "K3 bwd calls": k3,
           "K4": again * k4, "K4 calls": again * k4, "K4 bwd": 2 * k4,
           "K4 bwd calls": k4, **LABEL_LAUNCHES[patch], "K9": 4 * wide,
           "K10": 4 * segments if bwd_only else 0}
    return {k: v * steps for k, v in per.items()}


def median(times):
    warm = sorted(times[1:])
    return warm[len(warm) // 2]


# the large-patch train steps of bench.py's rows (512 px, batch 8; 1024 px,
# batch 2), without remat: (patch, batch, steps)
TRAIN_LARGE = ((512, 8, 5), (1024, 2, 4))


def phase_train_large(models, mods, smi, patch, batch, steps):
    """The dense-trunk step at a large patch: the label side takes K8 and
    the EDT kernel; the rest as the 256 px step."""
    counts, rows, times, peak, params = train_steps(
        models, steps, None, mods, patch=patch, batch=batch)
    want = expected_counts(steps, True, patch)
    if counts != want:
        fail(f"{patch} px train counts {counts}, expected {want}")
    if not rows[-1, 0] < rows[0, 0]:
        fail(f"loss did not fall over {steps} steps at {patch} px: "
             f"{rows[:, 0]}")
    med = median(times)
    row = {"phase": f"train_{patch}", "model": "ResUnetA d6 multitask",
           "routing": "dense trunk", "params": params, "patch": patch,
           "batch": batch, "dtype": "bfloat16", "optimizer": "adam 1e-4",
           "loss": "tanimoto x 4 heads", "steps": steps, "launches": counts,
           "launches_per_step": {k: v // steps for k, v in counts.items()},
           "first_step_s": times[0], "step_s": times,
           "median_warm_step_s": med, "patches_per_s": batch / med,
           "max_memory_allocated_bytes": peak,
           "loss_first": float(rows[0, 0]), "loss_last": float(rows[-1, 0]),
           "row_first": rows[0].tolist(), "row_last": rows[-1].tolist(),
           "card": smi}
    emit(row)
    torch.cuda.empty_cache()
    return row


def phase_train(models, mods, smi):
    # the dense trunk, the card's default routing (dense_trunk=None)
    prof = {}
    counts, rows, times, peak, params = train_steps(models, TRAIN_STEPS,
                                                    None, mods, profile=prof)
    want = expected_counts(TRAIN_STEPS, True)
    if counts != want:
        fail(f"dense-trunk train counts {counts}, expected {want}")
    if not rows[-1, 0] < rows[0, 0]:
        fail(f"loss did not fall over {TRAIN_STEPS} steps on one batch: "
             f"{rows[:, 0]}")
    med = median(times)
    row = {"phase": "train", "model": "ResUnetA d6 multitask",
           "routing": "dense trunk", "params": params,
           "patch": PATCH, "batch": TRAIN_BATCH, "dtype": "bfloat16",
           "optimizer": "adam 1e-4", "loss": "tanimoto x 4 heads",
           "steps": TRAIN_STEPS, "launches": counts,
           "first_step_s": times[0], "step_s": times,
           "median_warm_step_s": med,
           "patches_per_s": TRAIN_BATCH / med,
           "max_memory_allocated_bytes": peak,
           "loss_first": float(rows[0, 0]), "loss_last": float(rows[-1, 0]),
           "row_first": rows[0].tolist(), "row_last": rows[-1].tolist(),
           **prof, "busy_share": None if prof["device_ms_per_step"] is None
           else prof["device_ms_per_step"] / (med * 1e3),
           "busy_share_of": "device ms a step under the profiler over the "
                            "median warm step without it",
           "card": smi}
    emit(row)
    if prof["device_ms_per_step"] is None:
        fail("train: the profile of the step holds no device event")

    # the NHWC routing beside it: no K3, no K4
    n_counts, n_rows, n_times, n_peak, _ = train_steps(models, NHWC_STEPS,
                                                       False, mods)
    n_want = expected_counts(NHWC_STEPS, False)
    if n_counts != n_want:
        fail(f"NHWC train counts {n_counts}, expected {n_want}")
    n_med = median(n_times)
    emit({"phase": "train_nhwc", "routing": "NHWC (dense_trunk=False)",
          "steps": NHWC_STEPS, "launches": n_counts,
          "first_step_s": n_times[0], "step_s": n_times,
          "median_warm_step_s": n_med, "patches_per_s": TRAIN_BATCH / n_med,
          "max_memory_allocated_bytes": n_peak,
          "loss_first": float(n_rows[0, 0]), "card": smi})

    parity = step_card_vs_cpu()
    emit({"phase": "train_64px_f32", **parity})
    if parity["failed"]:
        fail(f"64 px step, card vs CPU: {parity['failed']} past their "
             f"limits: {parity['card_vs_cpu']} against {STEP_TOL}")
    return row


# the reference's opt-in train modes at full width, 3 steps each: (phase,
# ResUnetA arguments, patch, batch, expected_counts' arguments). bwd_wide
# adds RB(256)'s 12 segments (K1 + K9; RB(512) stays a cuDNN conv, the
# backward's wide ceiling being 256); segment mode "2" runs a plain
# forward and K2 in the NHWC routing (the dense trunk and tail off); tail
# mode "1" adds the five 3x3 head segments
TRAIN_MODES = (
    ("train_wide", {"bwd_wide": True}, PATCH, TRAIN_BATCH,
     {"dense": True, "segments": WIDE_TRAIN_SEGMENTS, "wide": 12}),
    ("train_wide_1024", {"bwd_wide": True}, 1024, 2,
     {"dense": True, "segments": WIDE_TRAIN_SEGMENTS, "wide": 12}),
    ("train_seg2", {"segment_mode": "2"}, PATCH, TRAIN_BATCH,
     {"dense": False, "k1": False, "bwd_only": True}),
    ("train_tail1", {"dense_tail": "1"}, PATCH, TRAIN_BATCH,
     {"dense": True, "segments": TAIL1_SEGMENTS}),
)
MODE_STEPS = 3
# the 64 px card-vs-CPU step of each mode (step_card_vs_cpu)
MODES_64PX = ({"bwd_wide": True}, {"segment_mode": "2"},
              {"dense_tail": "1"})


def phase_train_modes(models, mods, smi):
    """The opt-in modes' train steps (TRAIN_MODES): launches as
    expected_counts gives them, finite rows, a falling loss; the median
    warm step, patches/s and peak memory; then each mode's 64 px f32 step,
    card against the CPU plain path, at STEP_TOL."""
    out = {}
    for name, modes, patch, batch, want_kw in TRAIN_MODES:
        counts, rows, times, peak, params = train_steps(
            models, MODE_STEPS, None, mods, patch=patch, batch=batch,
            **modes)
        want = expected_counts(MODE_STEPS, patch=patch, **want_kw)
        if counts != want:
            fail(f"{name} train counts {counts}, expected {want}")
        if not rows[-1, 0] < rows[0, 0]:
            fail(f"loss did not fall over {MODE_STEPS} steps in {name}: "
                 f"{rows[:, 0]}")
        med = median(times)
        row = {"phase": name, "model": "ResUnetA d6 multitask",
               "modes": modes, "params": params, "patch": patch,
               "batch": batch, "dtype": "bfloat16", "steps": MODE_STEPS,
               "launches": counts,
               "launches_per_step": {k: v // MODE_STEPS
                                     for k, v in counts.items()},
               "first_step_s": times[0], "step_s": times,
               "median_warm_step_s": med, "patches_per_s": batch / med,
               "max_memory_allocated_bytes": peak,
               "loss_first": float(rows[0, 0]),
               "loss_last": float(rows[-1, 0]), "card": smi}
        emit(row)
        out[name] = row
        torch.cuda.empty_cache()
    for modes in MODES_64PX:
        parity = step_card_vs_cpu(threads=False, **modes)
        emit({"phase": "train_64px_f32_mode", **parity})
        if parity["failed"]:
            fail(f"64 px step in {modes}, card vs CPU: {parity['failed']} "
                 f"past their limits: {parity['card_vs_cpu']} against "
                 f"{STEP_TOL}")
    return out


# the train_cli phase: a packed set of CLI_PATCHES seeded 256 x 256 x 3
# patches with the 5 augmentation variants (50 samples, split by the CLI
# into 40 train and 10 validation) trained through the CLI's main in this
# process: CLI_EPOCHS epochs of 5 train steps and 1 eval step at batch
# CLI_BATCH, bf16, then a resume from the best checkpoint for one epoch at
# learning rate CLI_LR. Per eval step (eval mode, the NHWC routing): the
# 44 segments through K1 and the validation batch's labels
# (LABEL_LAUNCHES); no K2, K3 or K4.
CLI_PATCHES, CLI_BATCH, CLI_EPOCHS, CLI_LR = 10, 8, 2, 5e-4
EVAL_SEGMENTS = 44
WORK_DIR = Path(__file__).resolve().parent / "build"


def expected_eval_counts(steps, patch=PATCH):
    per = dict.fromkeys(expected_counts(1, True, patch), 0)
    per.update({"K1": EVAL_SEGMENTS, **LABEL_LAUNCHES[patch]})
    return {k: v * steps for k, v in per.items()}


def train_cli(work, mods, patch=PATCH, batch=CLI_BATCH, patches=CLI_PATCHES,
              epochs=CLI_EPOCHS, dtype="bfloat16"):
    """Write a seeded packed dataset under `work` with the port's
    write_packed_dataset, train the full-width multitask ResUnet-a d6 on it
    through resuneta_torch.cli.train_isprs.main (Tanimoto, Adam, `dtype`,
    the card's default routing), then resume from its best checkpoint for
    one epoch at CLI_LR. Every kernel count is set to 0 just before each
    run and read just after. Fails unless every history value is finite,
    the checkpoint and its meta JSON exist, the checkpoint restored into a
    fresh state equals the saved tensors bit for bit (and the run's final
    state where the last epoch saved it), and the resumed state has
    learning rate CLI_LR and the saved step plus one epoch's steps.
    Returns the runs' histories, times, counts and step counts."""
    from resuneta_torch.cli import train_isprs
    from resuneta_torch.data import (PackedDataset, native_loader,
                                     write_packed_dataset)
    from resuneta_torch.data.split import train_test_split
    from resuneta_torch.models import ResUnetA
    from resuneta_torch.train import checkpoint, create_train_state
    from resuneta_torch.train.loop import epoch_batches

    work = Path(work)
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(SEED + 7)
    data = work / "data"
    write_packed_dataset(
        str(data), rng.integers(0, 256, (patches, patch, patch, 3),
                                dtype=np.uint8),
        voronoi_ids(patches, patch, NUM_CLASSES, rng), NUM_CLASSES)
    n = len(PackedDataset(str(data)))
    n_val = len(train_test_split(np.arange(n))[1])
    per_epoch = (epoch_batches(n - n_val, batch)[0],
                 epoch_batches(n_val, batch)[0])
    ckpt = work / "run" / "best_model.ckpt"
    common = ["--resunet_a", "True", "--multitasking", "True", "--loss",
              "tanimoto", "--dtype", dtype, "-bs", str(batch), "-ps",
              str(patch), "-dp", str(data), "--seed", str(SEED)]
    counters = kernel_counters(mods)
    out = {}
    for name, extra, ep in (
            ("run", ["-rp", str(work / "run"), "--epochs", str(epochs)],
             epochs),
            ("resume", ["-rp", str(work / "resume"), "-cp", str(ckpt),
                        "-lr", str(CLI_LR), "--epochs", "1"], 1)):
        first = out.get("saved_step", 0)     # the step the run starts from
        for m, k in counters.values():
            setattr(m, k, 0)
        t0 = time.time()
        state, history = train_isprs.main(common + extra)
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = {key: getattr(m, k) for key, (m, k) in counters.items()}
        vals = [v for h in history for split in ("train", "val")
                for v in h[split].values()]
        if len(history) != ep or not np.isfinite(vals).all():
            fail(f"train_cli {name}: {len(history)} epochs of {ep}, or "
                 f"non-finite history: {history}")
        if state.step - first != per_epoch[0] * ep:
            fail(f"train_cli {name}: {state.step - first} train steps, "
                 f"expected {per_epoch[0]} x {ep} epochs")
        out[name] = {"state": state, "history": history, "seconds": secs,
                     "counts": counts, "train_steps": state.step - first,
                     "eval_steps": per_epoch[1] * ep}
        if name == "run":
            meta_path = Path(str(ckpt) + ".meta.json")
            if not (ckpt / checkpoint.CKPT_FILE).exists() or \
                    not meta_path.exists():
                fail(f"train_cli: no {ckpt} or no {meta_path}")
            saved = torch.load(ckpt / checkpoint.CKPT_FILE,
                               map_location="cpu", weights_only=True)
            fresh = create_train_state(
                ResUnetA(NUM_CLASSES, img_size=patch, multitasking=True,
                         generator=torch.Generator().manual_seed(SEED + 1)),
                "adam", 1e-3)
            fresh, meta = checkpoint.restore(str(ckpt), fresh)
            states = [fresh]
            if meta["epoch"] == epochs - 1:     # the final state was saved
                states.append(state)
            for st in states:
                bad = _state_differs(st, saved)
                if bad:
                    fail(f"train_cli: restored checkpoint differs at {bad}")
            out["meta"] = meta
            out["saved_step"] = saved["step"]
            out["compared_final_state"] = len(states) == 2
            del fresh
    # the resume's step was checked above: the saved step plus one epoch's
    if out["resume"]["state"].learning_rate != CLI_LR:
        fail(f"train_cli resume: lr {out['resume']['state'].learning_rate}, "
             f"expected {CLI_LR}")
    out["loader"] = native_loader.backend()
    for name in ("run", "resume"):
        del out[name]["state"]
    return out


def _state_differs(state, saved):
    """Names where a TrainState differs from a checkpoint's payload, bit
    for bit."""
    opt = state.optimizer.state_dict()
    bad = [k for k, v in state.model.state_dict().items()
           if not torch.equal(v.cpu(), saved["model"][k])]
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            if not torch.equal(torch.as_tensor(opt["state"][i][k]).cpu(), v):
                bad.append(f"optimizer {i} {k}")
    if opt["param_groups"] != saved["optimizer"]["param_groups"]:
        bad.append("optimizer param_groups")
    if state.step != saved["step"]:
        bad.append("step")
    return bad


def phase_train_cli(mods, smi):
    """train_cli at full width, 256 px, bf16 (CLI_*), the native row
    gather on: the launches of each run equal expected_counts for its
    train steps plus expected_eval_counts for its eval steps."""
    t0 = time.time()
    out = train_cli(WORK_DIR / "train_cli", mods)
    if out["loader"] != "native":
        fail(f"train_cli: the loader ran {out['loader']!r}, not 'native'")
    for name in ("run", "resume"):
        r = out[name]
        want = expected_counts(r["train_steps"], True)
        for k, v in expected_eval_counts(r["eval_steps"]).items():
            want[k] += v
        if r["counts"] != want:
            fail(f"train_cli {name} counts {r['counts']}, expected {want}")
    row = {"phase": "train_cli",
           "command": "python -m resuneta_torch.cli.train_isprs "
                      "--resunet_a True --multitasking True --loss tanimoto "
                      f"--dtype bfloat16 -bs {CLI_BATCH} -ps {PATCH} --epochs "
                      f"{CLI_EPOCHS}, then -cp <best> -lr {CLI_LR} --epochs 1",
           "patches": CLI_PATCHES, "samples": CLI_PATCHES * 5,
           "loader": out["loader"], "best_epoch": out["meta"]["epoch"],
           "saved_step": out["saved_step"],
           "restore_checked_against_final_state":
               out["compared_final_state"],
           "seconds": time.time() - t0, "card": smi}
    for name in ("run", "resume"):
        r = out[name]
        row[name] = {
            "seconds": r["seconds"], "train_steps": r["train_steps"],
            "eval_steps": r["eval_steps"],
            "patches_per_s": [h["patches_per_sec"] for h in r["history"]],
            "epoch_s": [h["time"] for h in r["history"]],
            "val_loss": [h["val"]["loss"] for h in r["history"]],
            "launches": r["counts"]}
    emit(row)
    torch.cuda.empty_cache()
    return row


# the amazon phase: the Amazon deforestation workload through the port's
# three CLIs in this process, on a seeded scene written under build/amazon/:
# two years of AMAZON_YEAR_BANDS bands each, CHW f32, AMAZON_SCENE (H, W) =
# 5 x 3 tiles of 512^2, a reference whose 128^2 cells hold a deforestation
# blob at random (each blob past the 5% filter), a past reference and an
# all -1 valid mask. The model is the full-width 14-band ResUnet-a d6
# without the colour head, multitask, f32 (the Amazon CLIs have no dtype),
# at 128 px, batch 8: per train step the dense trunk's launches at 128 px
# (expected_counts, f32: K3's backward 3 launches a call, 2 K4 calls each
# way), per eval step 44 K1 and the labels' EDT and Canny launches, and 44
# K1 a batch of AMAZON_EVAL_BATCH patches of the whole-scene prediction.
AMAZON_SCENE = (2560, 1536)
AMAZON_YEAR_BANDS = 7
AMAZON_BANDS = 2 * AMAZON_YEAR_BANDS
AMAZON_CLASSES = 3
AMAZON_PATCH, AMAZON_BATCH = 128, 8
AMAZON_EVAL_BATCH = 32        # infer.amazon.prediction's batch
AMAZON_STEPS = 10             # bare warm steps timed after the CLIs
AMAZON_HEADS = ("seg", "bound", "dist")
AMAZON_WCE = (0.5, 0.5, 0.0)  # the train CLI's default class weights
AMAZON_SCENE_ARGS = ["--image_t1", "t1.npy", "--image_t2", "t2.npy",
                     "--reference", "labels/ref.npy", "--past_reference",
                     "labels/past.npy", "--mask_ref", "mask_ref.npy"]


def amazon_scene(root):
    """Write the seeded Amazon_npy tree under `root`."""
    rng = np.random.default_rng(SEED + 11)
    H, W = AMAZON_SCENE
    root.mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(exist_ok=True)
    for name in ("t1", "t2"):
        bands = rng.standard_normal((AMAZON_YEAR_BANDS, H, W),
                                    dtype=np.float32)
        np.save(root / f"{name}.npy", bands * 300.0 + 1000.0)
    ref = np.zeros((H, W), np.uint8)
    past = np.zeros((H, W), np.uint8)
    P = AMAZON_PATCH
    for r in range(0, H, P):
        for c in range(0, W, P):
            if rng.uniform() < 0.5:       # >= (P/3)^2 px: past 5% of P^2
                h, w = rng.integers(P // 3, P * 5 // 8, 2)
                r0, c0 = r + rng.integers(0, P - h), c + rng.integers(0, P - w)
                ref[r0:r0 + h, c0:c0 + w] = 1
            if rng.uniform() < 0.2:
                h, w = rng.integers(P // 20, P // 5, 2)
                r0, c0 = r + rng.integers(0, P - h), c + rng.integers(0, P - w)
                past[r0:r0 + h, c0:c0 + w] = 1
    np.save(root / "labels" / "ref.npy", ref)
    np.save(root / "labels" / "past.npy", past)
    np.save(root / "mask_ref.npy", np.full((H, W), -1.0, np.float32))


def _run_cli(main, argv, log):
    """main(argv) in this process with its stdout kept in `log`: (what it
    returns, its stdout, seconds)."""
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    log.write_text(buf.getvalue())
    return out, buf.getvalue(), secs


def _eval_block(text):
    """An Amazon CLI's printed eval, the confusion matrix to the
    precision."""
    i = text.index("Confusion  matrix")
    return text[i:text.index("\n", text.index("Precision:", i))]


def amazon_warm_steps(mods):
    """AMAZON_STEPS bare train steps of the Amazon CLI's model at 128 px,
    batch 8, f32 on one seeded batch, every kernel count set to 0 just
    before and read just after (expected_counts). The first step pays the
    first calls at its shapes; the rate is over the others."""
    rng = np.random.default_rng(SEED + 3)
    raw = amazon_batch(AMAZON_BATCH, AMAZON_PATCH, rng)
    _, state, step = amazon_step("cuda", AMAZON_PATCH,
                                 torch.Generator().manual_seed(SEED))
    counters = kernel_counters(mods)
    for m, k in counters.values():
        setattr(m, k, 0)
    rows, times = [], []
    for _ in range(AMAZON_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        state, row = step(state, raw)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        rows.append(row.cpu().numpy())
    counts = {name: getattr(m, k) for name, (m, k) in counters.items()}
    want = expected_counts(AMAZON_STEPS, True, AMAZON_PATCH, f32=True)
    if counts != want:
        fail(f"amazon bare steps counts {counts}, expected {want}")
    if not np.isfinite(np.stack(rows)).all():
        fail(f"amazon bare steps: non-finite metric rows {rows}")
    warm = times[1:]
    med = median(times)
    return {"steps": AMAZON_STEPS, "launches": counts,
            "first_step_s": times[0], "step_s": times,
            "median_warm_step_s": med, "min_warm_step_s": min(warm),
            "max_warm_step_s": max(warm),
            "patches_per_s": AMAZON_BATCH / med}


def phase_amazon(mods, smi):
    """The Amazon workload end to end on the card: preprocess_amazon at
    128 px, stride 128; train_amazon (ResUnet-a, multitask, 1 epoch) in
    tile mode with its whole-scene eval, and from the preprocessed set;
    test_amazon on the tile run's best checkpoint, whose printed confusion
    matrix and metrics, and class-1 probability map, must equal the
    training eval's (one epoch: the checkpoint holds the weights that eval
    ran). Every kernel count is set to 0 before each CLI and read after;
    each must equal its expected counts. Then the 64 px Amazon step on the
    card against the CPU plain path (STEP_TOL) with the CPU's 1-thread
    against N-thread reading beside it; AMAZON_STEPS bare warm steps at
    128 px, batch 8 (the rate the CLI epochs' cold first steps cannot
    give); f32 K3 and K4 alone at the 128 px step's shapes (batch 8), and
    K5 and K6 bit for bit on 128^2 planes (label_planes(128)), against
    their plain versions."""
    from resuneta_torch.cli import (preprocess_amazon, test_amazon,
                                    train_amazon)
    from resuneta_torch.train.loop import epoch_batches

    t_phase = time.time()
    work = WORK_DIR / "amazon"
    shutil.rmtree(work, ignore_errors=True)
    data = work / "data"
    amazon_scene(data)
    torch.cuda.reset_peak_memory_stats()
    scene = ["--dataset_path", str(data)] + AMAZON_SCENE_ARGS
    P, B = str(AMAZON_PATCH), str(AMAZON_BATCH)
    model = ["--resunet_a", "True", "--multitasking", "True", "-ps", P,
             "--seed", str(SEED)]
    H, W = AMAZON_SCENE
    scene_batches = math.ceil((H // AMAZON_PATCH) * (W // AMAZON_PATCH) /
                              AMAZON_EVAL_BATCH)
    counters = kernel_counters(mods)

    def counted(name, main, argv):
        for m, k in counters.values():
            setattr(m, k, 0)
        out, text, secs = _run_cli(main, argv, work / f"{name}.log")
        return out, text, secs, {key: getattr(m, k)
                                 for key, (m, k) in counters.items()}

    def want(text, scene_eval):
        """expected_counts of the run's train and eval steps (its printed
        split sizes) and 44 K1 a batch of the whole-scene eval."""
        n_tr, n_val = map(int, re.search(
            r"Training patches: (\d+)  Validation patches: (\d+)",
            text).groups())
        steps = epoch_batches(n_tr, AMAZON_BATCH)[0]
        w = expected_counts(steps, True, AMAZON_PATCH, f32=True)
        for k, v in expected_eval_counts(
                epoch_batches(n_val, AMAZON_BATCH)[0], AMAZON_PATCH).items():
            w[k] += v
        w["K1"] += EVAL_SEGMENTS * scene_batches * scene_eval
        return w, steps, n_tr, n_val

    runs = {}
    _, text, secs, counts = counted(
        "preprocess", preprocess_amazon.main,
        scene + ["--patch_size", P, "--stride", P, "--output_path",
                 str(work / "prep")])
    if any(counts.values()):
        fail(f"amazon preprocess launched kernels: {counts}")
    manifest = json.loads((work / "prep" / "manifest.json").read_text())
    runs["preprocess"] = {"seconds": secs, "manifest": manifest}
    for name, extra, scene_eval in (
            ("train_tiles", ["--stride", P], True),
            ("train_preprocessed",
             ["--preprocessed_path", str(work / "prep")], False)):
        (state, history), text, secs, counts = counted(
            name, train_amazon.main,
            scene + model + ["-bs", B, "--epochs", "1", "-rp",
                             str(work / name)] + extra)
        w, steps, n_tr, n_val = want(text, scene_eval)
        vals = [v for h in history for split in ("train", "val")
                for v in h[split].values()]
        if len(history) != 1 or not np.isfinite(vals).all():
            fail(f"amazon {name}: non-finite history {history}")
        if state.step != steps:
            fail(f"amazon {name}: {state.step} train steps, expected {steps}")
        if counts != w:
            fail(f"amazon {name} counts {counts}, expected {w}")
        row = {"seconds": secs, "train_patches": n_tr, "val_patches": n_val,
               "train_steps": steps, "launches": counts,
               "patches_per_s": [h["patches_per_sec"] for h in history],
               "epoch_s": [h["time"] for h in history],
               "val_loss": [h["val"]["loss"] for h in history]}
        if scene_eval:
            test_s = float(re.search(r"test time (\S+)", text).group(1))
            row.update(eval=_eval_block(text), test_s=test_s,
                       scene_mpix_per_s=H * W / test_s / 1e6)
        runs[name] = row
        del state
    best = work / "train_tiles" / "best_model.ckpt"
    (metrics, cm), text, secs, counts = counted(
        "test", test_amazon.main,
        scene + model + ["--model_path", str(best), "--output_path",
                         str(work / "test")])
    w = dict.fromkeys(counts, 0)
    w["K1"] = EVAL_SEGMENTS * scene_batches
    if counts != w:
        fail(f"amazon test counts {counts}, expected {w}")
    if _eval_block(text) != runs["train_tiles"]["eval"]:
        fail("amazon test: its metrics differ from the training eval's:\n"
             f"{_eval_block(text)}\nagainst\n{runs['train_tiles']['eval']}")
    prob = np.load(work / "test" / "prob_reconstructed.npy")
    if not np.array_equal(prob, np.load(work / "train_tiles" /
                                        "prob_reconstructed.npy")):
        fail("amazon test: its probability map differs from training's")
    if prob.shape != (H, W) or not (np.isfinite(prob).all() and
                                   0 <= prob.min() <= prob.max() <= 1):
        fail(f"amazon test: probability map {prob.shape}, "
             f"[{prob.min()}, {prob.max()}]")
    test_s = float(re.search(r"test time (\S+)", text).group(1))
    runs["test"] = {"seconds": secs, "launches": counts, "test_s": test_s,
                    "scene_mpix_per_s": H * W / test_s / 1e6,
                    "confusion_matrix": cm.tolist(),
                    "accuracy": float(metrics[0])}
    peak = torch.cuda.max_memory_allocated()
    cli_s = time.time() - t_phase

    parity = step_card_vs_cpu(threads=True, amazon=True)
    emit({"phase": "amazon_64px_f32", **parity})
    if parity["failed"]:
        fail(f"64 px Amazon step, card vs CPU: {parity['failed']} past "
             f"their limits: {parity['card_vs_cpu']} against {STEP_TOL}")
    warm = amazon_warm_steps(mods)
    emit({"phase": "amazon_warm_steps", **warm, "card": smi})
    convseg, densemm, poolconv, distance, boundary = mods
    labels = phase_labels(distance, boundary, AMAZON_PATCH)
    k3_rows = phase_k3(densemm, torch.nn.functional, convseg,
                       k3_calls(AMAZON_PATCH), AMAZON_BATCH, torch.float32,
                       "k3_f32_128")
    k4_rows = phase_k4(poolconv, torch.nn.functional, convseg,
                       k4_calls(AMAZON_PATCH), AMAZON_BATCH, torch.float32,
                       "k4_f32_128")
    launches = {k: sum(r["launches"][k] for r in runs.values()
                       if "launches" in r) for k in counters}
    row = {"phase": "amazon",
           "model": "ResUnetA d6 multitask, 14 bands, 3 classes, no colour "
                    "head", "patch": AMAZON_PATCH, "batch": AMAZON_BATCH,
           "dtype": "float32", "scene": list(AMAZON_SCENE),
           "loss": "WCE on seg, bound, dist", "runs": runs,
           "launches": launches, "max_memory_allocated_bytes": peak,
           "warm_steps": warm, "cli_seconds": cli_s,
           "seconds": time.time() - t_phase, "card": smi}
    emit(row)
    torch.cuda.empty_cache()
    return row, k3_rows, k4_rows, labels


# the viz phase: the test CLI's multitask visualisation
# (cli/test_isprs.py: multitask_viz_panels, then matplotlib) on a seeded
# VIZ_SCENE^2 uint8 scene and Voronoi reference under build/viz/, the
# full-width multitask d6 (f32, the CLI's model, seeded weights) at 256 px,
# batch 32, --max_viz_patches VIZ_PATCHES: the eval's K1 launches (44 a
# batch) plus, per visualised patch, one EDT call (K5: 1 launch) and one
# Canny call (K6: 2) on its 5 reference planes
VIZ_SCENE, VIZ_PATCHES = 1024, 4
VIZ_DIR = WORK_DIR / "viz"


def _zero(counters):
    for m, k in counters.values():
        setattr(m, k, 0)


def _read(counters):
    return {name: getattr(m, k) for name, (m, k) in counters.items()}


def phase_viz(mods, smi):
    """cli.test_isprs.main --use_multitasking on the card: its launches,
    the files it writes (the figures where matplotlib imports, a printed
    line where it does not); then the panels of the first VIZ_PATCHES
    patches, computed on the card against the same function on the CPU
    from the same predictions and references: the one-hot, boundary and
    distance planes and the HSV bytes bit for bit, the RGB render within 1
    of 255, the difference map within 1e-5."""
    from resuneta_torch.cli import test_isprs
    from resuneta_torch.data.isprs import class_ids_to_rgb
    from resuneta_torch.infer.sliding import make_apply_fn, predict_patches
    from resuneta_torch.models import ResUnetA
    from resuneta_torch.ops.patches import extract_patches_nonoverlap
    from resuneta_torch.train.checkpoint import save_variables

    t0 = time.time()
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    emit({"phase": "viz_matplotlib", "importable": have_mpl})
    shutil.rmtree(VIZ_DIR, ignore_errors=True)
    VIZ_DIR.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 11)
    image = rng.integers(0, 256, (VIZ_SCENE, VIZ_SCENE, 3), dtype=np.uint8)
    ids = voronoi_ids(1, VIZ_SCENE, NUM_CLASSES, rng, sites=40)[0]
    np.save(VIZ_DIR / "Image_Test.npy", image.transpose(2, 0, 1))
    np.save(VIZ_DIR / "Reference_Test.npy",
            class_ids_to_rgb(ids).transpose(2, 0, 1))
    gen = torch.Generator().manual_seed(SEED)
    model = ResUnetA(NUM_CLASSES, img_size=PATCH, multitasking=True,
                     generator=gen, device="cpu")
    save_variables(VIZ_DIR / "weights.pt", model)
    out = VIZ_DIR / "out"
    counters = kernel_counters(mods)
    _zero(counters)
    (metrics, _), text, secs = _run_cli(test_isprs.main, [
        "--model_path", str(VIZ_DIR / "weights.pt"), "--dataset_path",
        str(VIZ_DIR), "-ps", str(PATCH), "--use_multitasking",
        "--output_path", str(out), "--batch_size", str(BATCH),
        "--max_viz_patches", str(VIZ_PATCHES)], VIZ_DIR / "cli.log")
    counts = _read(counters)
    n_batches = math.ceil((VIZ_SCENE // PATCH) ** 2 / BATCH)
    want = dict.fromkeys(counts, 0)
    want.update({"K1": EVAL_SEGMENTS * n_batches,
                 "K5/K7": VIZ_PATCHES * LABEL_LAUNCHES[PATCH]["K5/K7"],
                 "K6": VIZ_PATCHES * LABEL_LAUNCHES[PATCH]["K6"]})
    if counts != want:
        fail(f"viz: the test CLI's launches {counts}, expected {want}")
    files = sorted(f.name for f in out.iterdir())
    figures = [f"pred{i}_{kind}.jpg" for i in range(VIZ_PATCHES)
               for kind in ("classes", "color")]
    said = "matplotlib cannot be imported" in text
    if have_mpl and (said or not set(figures) <= set(files)) or \
            not have_mpl and (not said or set(figures) & set(files)):
        fail(f"viz: matplotlib importable {have_mpl}, files {files}, the "
             f"CLI said so: {said}")
    # the panels, card against CPU, from the same predictions
    patches = extract_patches_nonoverlap(image.astype(np.float32) / 255.0,
                                         PATCH)[:VIZ_PATCHES]
    refs = extract_patches_nonoverlap(ids, PATCH)[:VIZ_PATCHES]
    card_model = ResUnetA(NUM_CLASSES, img_size=PATCH, multitasking=True,
                          device="cpu")
    card_model.load_state_dict(model.state_dict())
    preds = predict_patches(make_apply_fn(card_model, "cuda"), patches,
                            VIZ_PATCHES)
    worst = {"rgb": 0, "diff": 0.0}
    for i in range(VIZ_PATCHES):
        pred = {k: v[i] for k, v in preds.items()}
        card = test_isprs.multitask_viz_panels(patches[i], refs[i], pred,
                                               NUM_CLASSES, "cuda")
        cpu = test_isprs.multitask_viz_panels(patches[i], refs[i], pred,
                                              NUM_CLASSES, "cpu")
        for k in ("img", "seg_ref", "bound_ref", "dist_ref", "hsv"):
            if not np.array_equal(card[k], cpu[k]):
                fail(f"viz patch {i}: {k} on the card differs from the CPU")
        worst["rgb"] = max(worst["rgb"], int(np.abs(
            card["rgb"].astype(int) - cpu["rgb"]).max()))
        worst["diff"] = max(worst["diff"], float(np.abs(
            card["diff"] - cpu["diff"]).max()))
    if worst["rgb"] > 1 or worst["diff"] > 1e-5:
        fail(f"viz: card against CPU render {worst}")
    row = {"phase": "viz", "command": "python -m resuneta_torch.cli."
           "test_isprs --use_multitasking -ps 256 --max_viz_patches "
           f"{VIZ_PATCHES}", "scene": [VIZ_SCENE, VIZ_SCENE],
           "patches": (VIZ_SCENE // PATCH) ** 2, "batches": n_batches,
           "launches": counts, "files": files,
           "matplotlib_importable": have_mpl,
           "cli_accuracy": float(metrics[0]), "cli_s": secs,
           "panels_card_vs_cpu": {"labels_and_hsv": "bit for bit",
                                  "rgb_max_abs": worst["rgb"],
                                  "diff_max_abs": worst["diff"]},
           "seconds": time.time() - t0, "card": smi}
    emit(row)
    return row


# the variants phase: the historical models and the legacy driver at full
# width on the card. Resunet_a(variant="v1") predicts V1_PATCHES seeded
# 256 px patches at batch 32 (44 K1 a batch); the legacy driver
# (compat.UNet, UnetConfig(): 512 x 512 x 3, 5 classes, batch 8, f32)
# trains one epoch on LEGACY_PAIRS seeded .npy image/label pairs under
# build/legacy/ (its split: 13 train, 3 validation: one train step of 44
# K1 launches and 44 K2 calls, one eval step of 44 K1), reloads in a fresh
# driver and predicts LEGACY_TEST images (44 K1 each); ResNet50UNet (14
# bands, 3 classes) forwards 8 patches of 128 px. The legacy images are
# low-contrast (within ~25 of the config mean): at random init a
# full-range image saturates the legacy softmax and the dual Tanimoto's
# prediction-volume weights turn inf (in the reference too).
V1_PATCHES, LEGACY_PAIRS, LEGACY_TEST = 64, 16, 2
LEGACY_DIR = WORK_DIR / "legacy"
LEGACY_SEGMENTS = 44                 # at 512 px: RB(32), RB(64), RB(128)
RESNET_BANDS, RESNET_CLASSES, RESNET_PATCH, RESNET_BATCH = 14, 3, 128, 8
RESNET_ATOL = 1e-4


def legacy_images(n, size, rng):
    """n low-contrast uint8 images around the config mean."""
    from resuneta_torch.utils.config import UnetConfig

    mean = np.asarray(UnetConfig().MEAN)
    return (mean + rng.normal(0, 8, (n, size, size, 3))).clip(0, 255).astype(
        np.uint8)


def legacy_step_64px(device, batch):
    """One Adam 1e-3 step of the 64 px legacy model (ResUnetALegacy, 5
    classes, f32, single-task Tanimoto) from seeded weights on `device`;
    returns the row, gradients and BN buffers in f64 on the CPU."""
    from resuneta_torch import losses
    from resuneta_torch.models import ResUnetALegacy
    from resuneta_torch.train import create_train_state, make_train_step

    model = ResUnetALegacy(NUM_CLASSES, img_size=64, device=device,
                           generator=torch.Generator().manual_seed(SEED + 7))
    state = create_train_state(model, "adam", 1e-3)
    step = make_train_step({"seg": losses.tanimoto_dual_loss}, {}, False,
                           device=device)
    _, row = step(state, batch)
    grads = {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()}
    bufs = {k: v.detach().cpu().double() for k, v in model.named_buffers()}
    return row.cpu().double(), grads, bufs


# the legacy 64 px step's limits: STEP_TOL's, but the last block's. The
# legacy model has no identity path and no BN outside its blocks, and at
# random init its last block's BN leaves get gradients of norm ~3e-4 from
# sums that nearly cancel: the order of f32 sums alone moves them by
# 0.078 relative L2 (one CPU thread against eight, no card), where
# the d6's last block moves by 0.042 (STEP_TOL's note). The limit keeps
# STEP_TOL's rule, 2.4x what the CPU alone shows (0.078 x 2.4 = 0.19,
# rounded to 0.2); a K2 that dropped dW reads 1.
LEGACY_LEAVES = {"heads": ("Conv_8",), "last_block": "ResBlockV1_4",
                 "dense_tail": None, "n_losses": 1}
LEGACY_STEP_TOL = {k: v for k, v in STEP_TOL.items()
                   if k != "dense_tail_rel_l2"}
LEGACY_STEP_TOL["last_block_rel_l2"] = 0.2


def legacy_step_card_vs_cpu():
    """legacy_step_64px on the card (TF32 off) against the CPU plain path
    from the same weights and batch, and the CPU with one thread against
    many (the order of sums alone): STEP_TOL's readings (the heads the
    logits conv Conv_8, the last block ResBlockV1_4: C = 32, eight fused
    segments; no dense tail) at LEGACY_STEP_TOL. Returns the readings,
    the card's launches and the names past their limits."""
    from resuneta_torch.ops import convseg

    rng = np.random.default_rng(SEED + 9)
    img = legacy_images(2, 64, rng).astype(np.float32)
    batch = {"image": img - np.asarray([82.0, 92.0, 88.0], np.float32),
             "seg": np.eye(NUM_CLASSES, dtype=np.float32)[
                 voronoi_ids(2, 64, NUM_CLASSES, rng)]}
    cpu = legacy_step_64px("cpu", batch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu1 = legacy_step_64px("cpu", batch)
    finally:
        torch.set_num_threads(n)
    before = (convseg.LAUNCHES, convseg.BWD_CALLS)
    with convseg.no_tf32():
        card = legacy_step_64px("cuda", batch)
    torch.cuda.synchronize()
    launches = {"K1": convseg.LAUNCHES - before[0],
                "K2 calls": convseg.BWD_CALLS - before[1]}
    errs = step_errors(card, cpu, **LEGACY_LEAVES)
    return {"card_vs_cpu": errs,
            f"cpu_1_vs_{n}_threads": step_errors(cpu1, cpu, **LEGACY_LEAVES),
            "tolerance": LEGACY_STEP_TOL, "launches": launches,
            "failed": [k for k, v in errs.items()
                       if not v < LEGACY_STEP_TOL[k]]}


def phase_variants(mods, smi):
    """V1's prediction (K1 a batch, one patch card against CPU within
    SEG_ATOL), the legacy driver's epoch, reload and predictions (finite
    history, the checkpoint restored bit for bit, ids in range, each
    step's K1 and K2 launches), its 64 px step card against CPU at
    LEGACY_STEP_TOL, and ResNet50UNet's forward card against CPU within
    RESNET_ATOL."""
    from types import SimpleNamespace

    from resuneta_torch.compat import Resunet_a, UNet
    from resuneta_torch.models import ResNet50UNet, ResUnetAV1
    from resuneta_torch.ops import convseg
    from resuneta_torch.train import checkpoint
    from resuneta_torch.train.loop import epoch_batches
    from resuneta_torch.utils.config import UnetConfig

    t_phase = time.time()
    counters = kernel_counters(mods)
    rng = np.random.default_rng(SEED + 12)
    row = {"phase": "variants", "card": smi}

    # V1 through the Keras-shaped entry point
    net = Resunet_a((PATCH, PATCH, 3), NUM_CLASSES,
                    SimpleNamespace(multitasking=True), variant="v1")
    x = rng.uniform(0, 1, (V1_PATCHES, PATCH, PATCH, 3)).astype(np.float32)
    _zero(counters)
    t0 = time.time()
    preds = net.predict(x, batch_size=BATCH)
    torch.cuda.synchronize()
    v1_s = time.time() - t0
    counts = _read(counters)
    n_batches = math.ceil(V1_PATCHES / BATCH)
    want = dict.fromkeys(counts, 0)
    want["K1"] = EVAL_SEGMENTS * n_batches
    if counts != want or not all(np.isfinite(v).all()
                                 for v in preds.values()):
        fail(f"variants V1: launches {counts} (expected {want}) or "
             "non-finite outputs")
    cpu = ResUnetAV1(NUM_CLASSES, img_size=PATCH, device="cpu")
    cpu.load_state_dict(net.model.state_dict())
    with torch.inference_mode():
        want_p = cpu(torch.from_numpy(x[:1]))
        with convseg.no_tf32():
            got_p = net.model(torch.from_numpy(x[:1]).cuda())
    v1_err = max((got_p[k].cpu() - want_p[k]).abs().max().item()
                 for k in want_p)
    if not v1_err <= SEG_ATOL:
        fail(f"variants V1: one patch card vs CPU max abs err {v1_err}")
    row["v1"] = {"params_with_bn_statistics": sum(
        p.numel() for p in net.model.parameters()) + sum(
        b.numel() for b in net.model.buffers()), "patches": V1_PATCHES,
        "batch": BATCH, "dtype": "float32", "launches": counts,
        "k1_launches_per_batch": counts["K1"] / n_batches,
        "predict_s": v1_s, "patches_per_s": V1_PATCHES / v1_s,
        "card_vs_cpu_max_abs_err": v1_err, "tolerance": SEG_ATOL}
    del net, cpu
    torch.cuda.empty_cache()

    # the legacy driver at its defaults
    config = UnetConfig()
    shutil.rmtree(LEGACY_DIR, ignore_errors=True)
    for sub in ("train", "label", "test"):
        (LEGACY_DIR / sub).mkdir(parents=True)
    size = config.IMAGE_W
    imgs = legacy_images(LEGACY_PAIRS + LEGACY_TEST, size, rng)
    labels = voronoi_ids(LEGACY_PAIRS, size, config.CLASSES_NUM, rng)
    for i in range(LEGACY_PAIRS):
        np.save(LEGACY_DIR / "train" / f"p{i:02d}.npy", imgs[i])
        np.save(LEGACY_DIR / "label" / f"p{i:02d}.npy", labels[i])
    logs = LEGACY_DIR / "logs"
    unet = UNet(config)
    _zero(counters)
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history = unet.train(str(LEGACY_DIR), str(logs), epochs=1)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = _read(counters)
    n_val = max(1, int(LEGACY_PAIRS * 0.2))
    steps = epoch_batches(LEGACY_PAIRS - n_val, config.BATCH_SIZE)[0]
    evals = epoch_batches(n_val, config.BATCH_SIZE)[0]
    want = dict.fromkeys(counts, 0)
    want.update({"K1": LEGACY_SEGMENTS * (steps + evals),
                 "K2": 4 * LEGACY_SEGMENTS * steps,
                 "K2 calls": LEGACY_SEGMENTS * steps})
    vals = [v for h in history for sp in ("train", "val")
            for v in h[sp].values()]
    if counts != want or len(history) != 1 or not np.isfinite(vals).all():
        fail(f"variants legacy: launches {counts} (expected {want}), "
             f"history {history}")
    fresh = UNet(config)
    fresh.loadWeight(str(logs))
    saved = torch.load(logs / "best_model.ckpt" / checkpoint.CKPT_FILE,
                       map_location="cpu", weights_only=True)
    bad = [k for k, v in fresh.model.state_dict().items()
           if not torch.equal(v.cpu(), saved["model"][k])]
    if bad:
        fail(f"variants legacy: the reloaded weights differ at {bad[:5]}")
    _zero(counters)
    t0 = time.time()
    ids = [fresh.predict(imgs[LEGACY_PAIRS + i])
           for i in range(LEGACY_TEST)]
    predict_s = time.time() - t0
    counts_p = _read(counters)
    if counts_p["K1"] != LEGACY_SEGMENTS * LEGACY_TEST or any(
            a.shape != (size, size) or a.min() < 0 or
            a.max() >= config.CLASSES_NUM for a in ids):
        fail(f"variants legacy predict: K1 {counts_p['K1']}, ids "
             f"{[(a.shape, a.min(), a.max()) for a in ids]}")
    parity = legacy_step_card_vs_cpu()
    if parity["failed"] or parity["launches"] != {
            "K1": 32, "K2 calls": 32}:
        fail(f"variants legacy 64 px step card vs CPU: {parity}")
    row["legacy"] = {
        "config": {k: v for k, v in config.__dict__.items()},
        "pairs": LEGACY_PAIRS, "train_steps": steps, "eval_steps": evals,
        "launches": counts, "predict_launches": counts_p,
        "history": [{"train_loss": float(h["train"]["loss"]),
                     "val_loss": float(h["val"]["loss"]),
                     "patches_per_s": float(h["patches_per_sec"])}
                    for h in history], "train_s": train_s,
        "predict_s_per_image": predict_s / LEGACY_TEST,
        "restored_bit_for_bit": True, "step_64px_f32": parity,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del unet, fresh
    torch.cuda.empty_cache()

    # ResNet50UNet, plain PyTorch (cuDNN), card against CPU
    rn = ResNet50UNet(RESNET_CLASSES, in_channels=RESNET_BANDS,
                      device="cpu",
                      generator=torch.Generator().manual_seed(SEED))
    xr = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, RESNET_PATCH, RESNET_PATCH, RESNET_BANDS)).astype(
        np.float32))
    with torch.inference_mode():
        want_r = rn(xr)
        rn.to("cuda")
        with convseg.no_tf32():
            got_r = rn(xr.cuda())
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: rn(xr.cuda()), 5)
    r_err = (got_r.cpu() - want_r).abs().max().item()
    if not r_err <= RESNET_ATOL:
        fail(f"variants ResNet50UNet card vs CPU max abs err {r_err}")
    row["resnet50_unet"] = {
        "params": sum(p.numel() for p in rn.parameters()),
        "input": [RESNET_BATCH, RESNET_PATCH, RESNET_PATCH, RESNET_BANDS],
        "card_vs_cpu_max_abs_err": r_err, "tolerance": RESNET_ATOL,
        "forward_ms": ms}
    del rn
    torch.cuda.empty_cache()
    row["seconds"] = time.time() - t_phase
    emit(row)
    return row


# the remat_1024 phase: the default 1024 px x 2 bf16 step (dense trunk),
# REMAT_STEPS steps without remat and REMAT_STEPS with it in this process
REMAT_STEPS = 3


def phase_remat_1024(models, mods, smi):
    """make_train_step(remat=True) at 1024 px: the launches
    expected_counts(remat=True) gives, the rows within STEP_TOL's loss
    limit and 2e-3 (accuracy, counts of the elements) of the step
    without remat from the same weights and batch; each run's peak memory
    and median warm step."""
    t0 = time.time()
    runs = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        counts, rows, times, peak, params = train_steps(
            models, REMAT_STEPS, None, mods, patch=1024, batch=2,
            remat=remat)
        want = expected_counts(REMAT_STEPS, True, 1024, remat=remat)
        if counts != want:
            fail(f"remat_1024 (remat={remat}) counts {counts}, expected "
                 f"{want}")
        runs[remat] = {"launches": counts, "rows": rows, "step_s": times,
                       "median_warm_step_s": median(times),
                       "max_memory_allocated_bytes": peak}
    r0 = runs[False]["rows"].astype(np.float64)
    r1 = runs[True]["rows"].astype(np.float64)
    n = 2 * 1024 * 1024 * NUM_CLASSES
    readings = {"loss_rel": float(np.max(np.abs(r1[:, :5] - r0[:, :5]) /
                                         np.abs(r0[:, :5]))),
                "accuracy_abs": float(np.max(np.abs(r1[:, 5] - r0[:, 5]))),
                "counts_abs_of_elements": float(
                    np.max(np.abs(r1[:, 6:] - r0[:, 6:]))) / n}
    limits = {"loss_rel": STEP_TOL["loss_rel"], "accuracy_abs": 2e-3,
              "counts_abs_of_elements": 2e-3}
    failed = [k for k, v in readings.items() if not v < limits[k]]
    if failed:
        fail(f"remat_1024: rows with remat differ: {readings} against "
             f"{limits}")
    row = {"phase": "remat_1024", "model": "ResUnetA d6 multitask",
           "routing": "dense trunk", "patch": 1024, "batch": 2,
           "dtype": "bfloat16", "steps": REMAT_STEPS,
           "rows_bit_for_bit": bool(np.array_equal(r0, r1)),
           "readings": readings, "limits": limits,
           **{("remat" if k else "plain"): {
               kk: (v.tolist() if kk == "rows" else v)
               for kk, v in run.items()} for k, run in runs.items()},
           "peak_ratio": runs[True]["max_memory_allocated_bytes"] /
           runs[False]["max_memory_allocated_bytes"],
           "step_ratio": runs[True]["median_warm_step_s"] /
           runs[False]["median_warm_step_s"],
           "seconds": time.time() - t0, "card": smi}
    emit(row)
    torch.cuda.empty_cache()
    return row


# the dist phase: data-parallel training on the card (resuneta_torch.
# parallel). DIST_RANKS processes share the one card over gloo (NCCL
# refuses two ranks on one card), each with TRAIN_BATCH / DIST_RANKS rows of
# the global batch of TRAIN_BATCH, and take DIST_STEPS SGD steps of the
# full-width multitask d6 at 256 px in bf16 (SGD: its update is linear in
# the gradient, so the parameters after the steps bound the gradients'
# mismatch); held against the same steps in this process on the whole
# batch at STEP_TOL, the ranks' parameters equal bit for bit. Then a
# one-epoch train_model over the ranks on train_cli's packed set, rank 0
# alone writing. With two cards or more, the same over NCCL, one card a
# rank, and the CLI's --gpu_parallel True on every card.
DIST_RANKS, DIST_STEPS, DIST_LR = 2, 3, 1e-3
DIST_DIR = WORK_DIR / "dist"


def dist_steps(group, patch=PATCH, batch=TRAIN_BATCH, steps=DIST_STEPS,
               dtype=torch.bfloat16, space=False):
    """`steps` SGD train steps of the ISPRS multitask d6 at full width from
    seeded weights, on this rank's rows of a seeded global batch of
    `batch` (all of it without a group), every kernel count set to 0 just
    before and read just after. With `space` the group is a SpaceMesh and
    the rank holds its rows and band (shard_batch_spatial); without a
    group the steps then run inside convseg.disabled(), the space step's
    routing. Returns the launches, the metric rows, the step times and the
    state_dict before and after, on the CPU."""
    from resuneta_torch import losses, models
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.ops import (boundary, convseg, densemm, distance,
                                    poolconv)
    from resuneta_torch.parallel import shard_batch, shard_batch_spatial
    from resuneta_torch.train import create_train_state, make_train_step

    dev = group.device if group is not None else torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    raw = (shard_batch_spatial if space and group is not None else
           shard_batch)({
        "image_u8": rng.integers(0, 256, (batch, patch, patch, 3),
                                 dtype=np.uint8),
        "label_ids": voronoi_ids(batch, patch, NUM_CLASSES, rng),
        "aug": rng.integers(0, 5, batch)}, group)
    model = models.ResUnetA(NUM_CLASSES, img_size=patch, multitasking=True,
                            dtype=dtype, device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    state = create_train_state(model, "sgd", DIST_LR)
    step = make_train_step(
        losses.make_losses("tanimoto"), {h: 1.0 for h in HEADS}, True,
        preprocess=make_device_pipeline(NUM_CLASSES, 1, device=dev),
        device=dev, group=group)
    counters = kernel_counters((convseg, densemm, poolconv, distance,
                                boundary))
    for m, k in counters.values():
        setattr(m, k, 0)
    rows, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        with convseg.disabled(space):
            state, row = step(state, raw)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        rows.append(row.cpu().numpy())
    return {"counts": {name: getattr(m, k)
                       for name, (m, k) in counters.items()},
            "rows": np.stack(rows), "times": times, "before": before,
            "after": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def dist_train_model(group, data, work, patch=PATCH):
    """One epoch of train_model over the group on the packed set of
    `patch` px patches at `data` (the CLI's split, batch CLI_BATCH, the
    full-width d6, bf16, Adam),
    into work/train_model_rank<r>, every kernel count set to 0 just before
    and read just after; stdout captured."""
    from resuneta_torch import losses
    from resuneta_torch.data import PackedDataset, make_device_pipeline
    from resuneta_torch.data.split import train_test_split
    from resuneta_torch.models import ResUnetA
    from resuneta_torch.ops import (boundary, convseg, densemm, distance,
                                    poolconv)
    from resuneta_torch.parallel import replicate_state
    from resuneta_torch.train import (TrainConfig, create_train_state,
                                      make_eval_step, make_train_step,
                                      train_model)

    dev = group.device
    full = PackedDataset(str(data))
    tr, va = train_test_split(np.arange(len(full)), test_size=0.2,
                              random_state=42)
    model = ResUnetA(NUM_CLASSES, img_size=patch, multitasking=True,
                     dtype=torch.bfloat16, device=dev,
                     generator=torch.Generator().manual_seed(SEED))
    state = replicate_state(create_train_state(model, "adam", 1e-4), group)
    pipe = make_device_pipeline(NUM_CLASSES, 1, device=dev)
    args = (losses.make_losses("tanimoto"), {h: 1.0 for h in HEADS}, True)
    ts = make_train_step(*args, preprocess=pipe, device=dev, group=group)
    es = make_eval_step(*args, preprocess=pipe, device=dev, group=group)
    config = TrainConfig(results_path=str(work / f"train_model_rank"
                                               f"{group.rank}"),
                         batch_size=CLI_BATCH, epochs=1, multitasking=True,
                         seed=SEED)
    counters = kernel_counters((convseg, densemm, poolconv, distance,
                                boundary))
    for m, k in counters.values():
        setattr(m, k, 0)
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        state, history = train_model(config, state, ts, es, full.subset(tr),
                                     full.subset(va), group=group)
    torch.cuda.synchronize()
    return {"history": history, "seconds": time.time() - t0,
            "counts": {name: getattr(m, k)
                       for name, (m, k) in counters.items()},
            "train_steps": state.step, "printed": bool(out.getvalue()),
            "results_path": config.results_path}


# predict_scene_overlap over the ranks: a seeded OVERLAP_SCENE^2 scene in
# 256 px windows every OVERLAP_STRIDE px (7 x 7 = 49 windows), the
# full-width multitask d6 in bf16, a global batch of 32 (16 rows a rank);
# held bit for bit against this process at batch 16, the same forward
# batches
OVERLAP_SCENE, OVERLAP_STRIDE = 1024, 128


def dist_overlap(group, patch=PATCH, batch=BATCH):
    """predict_scene_overlap(group=) on this rank (or, without a group, in
    this process at the per-rank batch), every kernel count set to 0 just
    before and read just after. Returns the map, the mean probabilities,
    the launches and the seconds."""
    from resuneta_torch.infer.sliding import (make_apply_fn,
                                              predict_scene_overlap)
    from resuneta_torch.models import ResUnetA
    from resuneta_torch.ops import (boundary, convseg, densemm, distance,
                                    poolconv)

    dev = group.device if group is not None else torch.device("cuda")
    scene = np.random.default_rng(SEED + 13).uniform(
        0, 1, (OVERLAP_SCENE, OVERLAP_SCENE, 3)).astype(np.float32)
    model = ResUnetA(NUM_CLASSES, img_size=patch, multitasking=True,
                     dtype=torch.bfloat16, device=dev,
                     generator=torch.Generator().manual_seed(SEED))
    counters = kernel_counters((convseg, densemm, poolconv, distance,
                                boundary))
    _zero(counters)
    t0 = time.time()
    cmap, mean = predict_scene_overlap(
        make_apply_fn(model, dev), scene, patch, OVERLAP_STRIDE,
        batch if group is not None else batch // DIST_RANKS, group=group)
    torch.cuda.synchronize()
    return {"map": cmap, "mean": mean, "counts": _read(counters),
            "seconds": time.time() - t0}


def dist_rank(rank, world, backend, init_method, work, patch, batch, steps,
              dtype, data, mesh_shape=None):
    """One rank of dist_compare: gloo on the one card (ranks share it), or
    NCCL on the card of its rank; a rank of a (data, space) mesh of
    `mesh_shape` where given. With `data` (the gloo run), also the
    one-epoch train_model and the sharded overlap inference. Saves what
    it ran to work/rank<r>.pt."""
    from resuneta_torch.parallel import (destroy_group, init_group,
                                         make_mesh_2d)

    kw = dict(rank=rank, world_size=world, init_method=init_method,
              gloo_on_cuda=backend == "gloo")
    dev = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    group = init_group(backend, dev, **kw) if mesh_shape is None else \
        make_mesh_2d(*mesh_shape, backend, dev, **kw)
    try:
        out = dist_steps(group, patch, batch, steps, dtype,
                         space=mesh_shape is not None)
        out["backend"], out["device"] = group.backend, str(group.device)
        if data is not None:
            out["train_model"] = dist_train_model(group, data, work, patch)
            out["overlap"] = dist_overlap(group, patch)
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        destroy_group(group)


def dist_compare(backend, work, patch=PATCH, batch=TRAIN_BATCH,
                 steps=DIST_STEPS, dtype=torch.bfloat16, data=None,
                 ranks=DIST_RANKS, mesh_shape=None):
    """dist_steps over `ranks` spawned ranks on `backend` (a (data, space)
    mesh of `mesh_shape` where given: its ranks, and K1-K4 off in both
    runs) against dist_steps in this process on the whole batch, from the
    same weights and batch: the rows (losses within STEP_TOL's loss_rel,
    the accuracy within 2e-3, the counts within 2e-3 of the elements, as
    tests/test_torch_train.py holds them), the SGD update over every
    parameter (grads_rel_l2) and each head leaf (heads_rel_l2), each BN
    running variance, and the running means all at once
    (bn_running_rel_l2); the ranks' parameters and buffers bit for bit,
    their launches against expected_counts. Returns the readings and the
    names of those past their limits; the ranks' results under
    "ranks_out".

    The running means are held all at once, not one by one: a BN fed by
    a BN's bf16 output has a batch mean that is only the rounding of that
    output's bf16 offset b, which an f32 sum in another order moves by a
    bf16 ulp, so its running mean differs by up to 100% between two right
    programs (0.75 relative L2 on an H100 at 256 px, bf16), while it
    weighs nothing in the means' norm."""
    from resuneta_torch.parallel import launch

    space = mesh_shape is not None
    if space:
        ranks = mesh_shape[0] * mesh_shape[1]
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.time()
    launch.spawn(dist_rank, ranks, (ranks, backend, launch.rendezvous(
        str(work)), work, patch, batch, steps, dtype, data, mesh_shape),
        timeout_s=600)
    spawn_s = time.time() - t0
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(ranks)]
    one = dist_steps(None, patch, batch, steps, dtype, space=space)
    torch.cuda.empty_cache()
    r0 = got[0]
    failed = []
    if any(not torch.equal(v, g["after"][k]) for g in got[1:]
           for k, v in r0["after"].items()) or \
            any(not np.array_equal(g["rows"], r0["rows"]) for g in got[1:]):
        failed.append("ranks_bit_for_bit")
    # the space step: K1-K4 off, the labels' EDT and Canny on whole planes
    want = expected_counts(steps, False, patch, segments=0) if space else \
        expected_counts(steps, True, patch, f32=dtype == torch.float32)
    if any(g["counts"] != want for g in got) or one["counts"] != want:
        failed.append("launches")
    rg, rw = r0["rows"].astype(np.float64), one["rows"].astype(np.float64)
    n = batch * patch * patch * NUM_CLASSES
    loss_rel = float(np.max(np.abs(rg[:, :5] - rw[:, :5]) /
                            np.abs(rw[:, :5])))
    acc_abs = float(np.max(np.abs(rg[:, 5] - rw[:, 5])))
    counts_abs = float(np.max(np.abs(rg[:, 6:] - rw[:, 6:])))
    leaves = [k for k in r0["before"] if not k.endswith((".mean", ".var"))]
    means = [k for k in r0["before"] if k.endswith(".mean")]
    bn_rel = {k: rel_l2(r0["after"][k].double(), one["after"][k].double())
              for k in r0["before"] if k.endswith((".mean", ".var"))}
    du = {k: (r0["after"][k] - r0["before"][k]).double() for k in leaves}
    dw = {k: (one["after"][k] - one["before"][k]).double() for k in leaves}
    readings = {
        "loss_rel": loss_rel,
        "accuracy_abs": acc_abs,
        "counts_abs_of_elements": counts_abs / n,
        "update_rel_l2": rel_l2(torch.cat([du[k].ravel() for k in leaves]),
                                torch.cat([dw[k].ravel() for k in leaves]),
                                atol=0),
        "heads_update_rel_l2": max(
            rel_l2(du[k], dw[k], atol=1e-6 * DIST_LR) for k in leaves
            if k.split(".")[0] in HEAD_LEAVES),
        "bn_running_var_rel_l2": max(v for k, v in bn_rel.items()
                                     if k.endswith(".var")),
        "bn_running_means_rel_l2": rel_l2(
            torch.cat([r0["after"][k].double() for k in means]),
            torch.cat([one["after"][k].double() for k in means]))}
    limits = {"loss_rel": STEP_TOL["loss_rel"], "accuracy_abs": 2e-3,
              "counts_abs_of_elements": 2e-3,
              "update_rel_l2": STEP_TOL["grads_rel_l2"],
              "heads_update_rel_l2": STEP_TOL["heads_rel_l2"],
              "bn_running_var_rel_l2": STEP_TOL["bn_running_rel_l2"],
              "bn_running_means_rel_l2": STEP_TOL["bn_running_rel_l2"]}
    failed += [k for k, v in readings.items() if not v < limits[k]]
    worst = sorted(bn_rel, key=bn_rel.get)[-3:]
    return {"backend": backend, "ranks": ranks, "patch": patch,
            "mesh": None if not space else {"data": mesh_shape[0],
                                            "space": mesh_shape[1]},
            "global_batch": batch, "rows_a_rank": batch // (
                mesh_shape[0] if space else ranks),
            "dtype": str(dtype).replace("torch.", ""), "steps": steps,
            "readings": readings, "limits": limits, "failed": failed,
            "bn_worst_buffers": {k: {"rel_l2": bn_rel[k], "norm": float(
                one["after"][k].norm())} for k in worst},
            "launches_a_rank": r0["counts"], "expected_launches": want,
            "step_s_rank0": r0["times"], "median_warm_step_s_rank0":
                median(r0["times"]),
            "step_s_one_process": one["times"],
            "median_warm_step_s_one_process": median(one["times"]),
            "launches_by_rank": [g["counts"] for g in got],
            "spawn_and_run_s": spawn_s, "ranks_out": got}


def phase_dist(smi):
    """dist_compare over gloo on this card at the train phase's shapes,
    with a one-epoch train_model over the ranks on train_cli's packed set;
    with two cards or more, the same over NCCL and the CLI's
    --gpu_parallel True. Fails unless the readings are within their
    limits, the launches are each rank's expected_counts (and the
    train_model's expected_counts plus expected_eval_counts), and rank 0
    alone printed and wrote its checkpoint."""
    t0 = time.time()
    torch.cuda.empty_cache()
    data = WORK_DIR / "train_cli" / "data"
    res = dist_compare("gloo", DIST_DIR / "gloo", data=data)
    outs = res.pop("ranks_out")
    tms = [g["train_model"] for g in outs]
    if res["failed"]:
        fail(f"dist (gloo): {res['failed']} failed: {res['readings']} "
             f"against {res['limits']}")
    # the sharded overlap inference against this process's
    one = dist_overlap(None)
    n_windows = len(range(0, OVERLAP_SCENE - PATCH + 1, OVERLAP_STRIDE))
    per_rank_batches = math.ceil(n_windows ** 2 / BATCH)
    for r, g in enumerate(outs):
        ov = g["overlap"]
        if not (np.array_equal(ov["map"], one["map"]) and
                np.array_equal(ov["mean"], one["mean"])):
            fail(f"dist overlap: rank {r}'s map differs from this "
                 "process's: max abs prob diff "
                 f"{np.abs(ov['mean'] - one['mean']).max()}, map agreement "
                 f"{np.mean(ov['map'] == one['map'])}")
        if ov["counts"]["K1"] != EVAL_SEGMENTS * per_rank_batches:
            fail(f"dist overlap: rank {r} launched K1 {ov['counts']['K1']} "
                 f"times, expected {EVAL_SEGMENTS * per_rank_batches}")
    res["overlap"] = {
        "scene": [OVERLAP_SCENE, OVERLAP_SCENE], "stride": OVERLAP_STRIDE,
        "windows": n_windows ** 2, "global_batch": BATCH,
        "bit_for_bit_with_one_process": True,
        "seconds_by_rank": [g["overlap"]["seconds"] for g in outs],
        "seconds_one_process": one["seconds"],
        "k1_launches_a_rank": outs[0]["overlap"]["counts"]["K1"],
        "class_histogram": np.bincount(one["map"].ravel(),
                                       minlength=NUM_CLASSES).tolist()}
    from resuneta_torch.data import PackedDataset
    from resuneta_torch.data.split import train_test_split
    from resuneta_torch.train.loop import epoch_batches
    n = len(PackedDataset(str(data)))
    n_val = len(train_test_split(np.arange(n), test_size=0.2,
                                 random_state=42)[1])
    steps = epoch_batches(n - n_val, CLI_BATCH, DIST_RANKS)[0]
    evals = epoch_batches(n_val, CLI_BATCH, DIST_RANKS)[0]
    want = expected_counts(steps, True)
    for k, v in expected_eval_counts(evals).items():
        want[k] += v
    for r, tm in enumerate(tms):
        vals = [v for h in tm["history"] for sp in ("train", "val")
                for v in h[sp].values()]
        if tm["counts"] != want or tm["train_steps"] != steps or \
                not np.isfinite(vals).all():
            fail(f"dist train_model rank {r}: counts {tm['counts']} "
                 f"(expected {want}), {tm['train_steps']} steps "
                 f"(expected {steps}), history {tm['history']}")
    ckpt = Path(tms[0]["results_path"]) / "best_model.ckpt" / "checkpoint.pt"
    if not ckpt.exists() or Path(tms[1]["results_path"]).exists() or \
            not tms[0]["printed"] or tms[1]["printed"]:
        fail("dist train_model: rank 0 alone must print and write its "
             f"checkpoint ({ckpt}); rank 1 printed {tms[1]['printed']}, "
             f"wrote {Path(tms[1]['results_path']).exists()}")
    row = {"phase": "dist", **res, "card": smi,
           "train_model": {
               "epochs": 1, "global_batch": CLI_BATCH,
               "train_steps": steps, "eval_steps": evals,
               "seconds_by_rank": [tm["seconds"] for tm in tms],
               "patches_per_s": tms[0]["history"][0]["patches_per_sec"],
               "launches_a_rank": tms[0]["counts"],
               "checkpoint_by_rank_0_alone": True},
           "note": "two ranks share one card: a smoke reading, not a "
                   "scaling figure"}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl = dist_compare("nccl", DIST_DIR / "nccl")
        nccl.pop("ranks_out")
        if nccl["failed"]:
            fail(f"dist (nccl): {nccl['failed']} failed: "
                 f"{nccl['readings']} against {nccl['limits']}")
        row["nccl"] = nccl
        row["cli_gpu_parallel"] = dist_cli(data, n_cards)
    else:
        row["nccl"] = {"ran": False, "why": f"{n_cards} card visible: NCCL "
                       "takes one card a rank"}
    row["seconds"] = time.time() - t0
    emit(row)
    return row, tms, [g["overlap"]["counts"] for g in outs]


def dist_cli(data, n_cards):
    """resuneta_torch.cli.train_isprs.main with --gpu_parallel True: one
    rank a card (NCCL), 1 epoch, batch CLI_BATCH * n_cards; rank 0's
    history finite and its checkpoint written."""
    from resuneta_torch.cli import train_isprs

    rp = DIST_DIR / "cli"
    shutil.rmtree(rp, ignore_errors=True)
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, history = train_isprs.main([
            "--resunet_a", "True", "--multitasking", "True", "--loss",
            "tanimoto", "--dtype", "bfloat16", "-bs",
            str(CLI_BATCH * n_cards), "-ps", str(PATCH), "-dp", str(data),
            "--epochs", "1", "--gpu_parallel", "True", "-rp", str(rp)])
    vals = [v for h in history for sp in ("train", "val")
            for v in h[sp].values()]
    ckpt = rp / "best_model.ckpt" / "checkpoint.pt"
    if state is not None or len(history) != 1 or \
            not np.isfinite(vals).all() or not ckpt.exists():
        fail(f"--gpu_parallel True on {n_cards} cards: state {state}, "
             f"history {history}, checkpoint {ckpt.exists()}")
    return {"ran": True, "cards": n_cards, "seconds": time.time() - t0,
            "patches_per_s": history[0]["patches_per_sec"],
            "val_loss": history[0]["val"]["loss"]}


# the space axis: the train step height-sharded over a (data, space)
# mesh, as dist_compare holds it; two gloo ranks share this card as 1 x 2,
# with 2+ cards NCCL at 1 x 2, with 4+ at 2 x 2
SPACE_DIR = WORK_DIR / "space"


def phase_space(smi):
    """dist_compare over (data, space) meshes at the train phase's shapes
    (the full-width multitask d6, 256 px, a global batch of 16, bf16, 3
    SGD steps): each rank's band of 128 (1 x 2) rows, halos and gathers
    through the host over gloo, on the card over NCCL; against this
    process on the whole batch in the same routing (K1-K4 off). Fails
    unless the readings are within STEP_TOL's limits, the ranks agree bit
    for bit, and each rank launched no K1-K4 and the labels' EDT and
    Canny on whole planes (expected_counts(3, False, segments=0))."""
    t0 = time.time()
    torch.cuda.empty_cache()
    runs = [("gloo", (1, 2))]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("nccl", (1, 2)))
    if n_cards >= 4:
        runs.append(("nccl", (2, 2)))
    out = {}
    for backend, shape in runs:
        name = f"{backend}_{shape[0]}x{shape[1]}"
        res = dist_compare(backend, SPACE_DIR / name, mesh_shape=shape)
        res.pop("ranks_out")
        if res["failed"]:
            fail(f"space ({name}): {res['failed']} failed: "
                 f"{res['readings']} against {res['limits']}")
        out[name] = res
    row = {"phase": "space", "runs": out, "card": smi,
           "cards": n_cards, "seconds": time.time() - t0,
           "note": "ranks sharing one card over gloo: a smoke reading, not "
                   "a scaling figure"}
    emit(row)
    return row


def phase_trajectory(mods, smi):
    """The bf16 trajectory gate (resuneta_torch/utils/trajectory.py): the
    fixed 64 px multitask workload, 5 Adam steps in bf16 on the card (the
    dense trunk, K1-K6 live), every loss within BAND of the port's CPU
    f32 pin."""
    from resuneta_torch.utils import trajectory

    counters = kernel_counters(mods)
    _zero(counters)
    t0 = time.time()
    losses = trajectory.run_losses(dtype=torch.bfloat16)
    torch.cuda.synchronize()
    secs = time.time() - t0
    ok = trajectory.check(losses)
    row = {"phase": "trajectory", "losses": losses,
           "reference": trajectory.REFERENCE_LOSSES, "band": trajectory.BAND,
           "worst": max(abs(l / r - 1.0) for l, r in
                        zip(losses, trajectory.REFERENCE_LOSSES)),
           "ok": ok, "dtype": "bfloat16", "seconds": secs,
           "launches": _read(counters), "card": smi}
    emit(row)
    if not ok:
        fail(f"trajectory: bf16 losses {losses} outside {trajectory.BAND} "
             f"of {trajectory.REFERENCE_LOSSES}")
    return row


QUICKSTART_DIR = WORK_DIR / "quickstart"


def phase_quickstart(mods, smi):
    """examples/quickstart_torch.py on the card (its defaults: 3 epochs,
    64 px, stride 32, f32) under build/quickstart/: the packed set, a
    finite history, the checkpoint, the whole-scene test's metrics and
    reconstruction."""
    import importlib.util

    shutil.rmtree(QUICKSTART_DIR, ignore_errors=True)
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", Path(__file__).resolve().parent / "examples" /
        "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    counters = kernel_counters(mods)
    _zero(counters)
    t0 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = mod.main(["--workdir", str(QUICKSTART_DIR)])
    torch.cuda.synchronize()
    secs = time.time() - t0
    hist = res["history"]
    vals = [v for h in hist for sp in ("train", "val")
            for v in h[sp].values()]
    ckpt = Path(res["checkpoint"]) / "checkpoint.pt"
    recon = Path(res["predictions"]) / "pred_seg_reconstructed.jpeg"
    acc = float(res["metrics"][0])
    row = {"phase": "quickstart", "seconds": secs,
           "stage_seconds": res["seconds"], "epochs": len(hist),
           "train_loss_by_epoch": [h["train"]["loss"] for h in hist],
           "val_loss_by_epoch": [h["val"]["loss"] for h in hist],
           "patches_per_s_by_epoch": [h.get("patches_per_sec") for h in hist],
           "test_accuracy": acc, "checkpoint": ckpt.exists(),
           "reconstruction": recon.exists(), "launches": _read(counters),
           "card": smi}
    emit(row)
    if len(hist) != 3 or not np.isfinite(vals).all() or not ckpt.exists() \
            or not recon.exists() or not 0 <= acc <= 100:
        fail(f"quickstart: history {hist}, checkpoint {ckpt.exists()}, "
             f"reconstruction {recon.exists()}, accuracy {acc}")
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from resuneta_torch import models
    from resuneta_torch.infer import sliding
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import (boundary, convseg, densemm, distance,
                                    poolconv)

    torch.manual_seed(SEED)
    phase_s = {}

    def timed(name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        phase_s[name] = time.time() - t0
        return out

    smi = timed("build", phase_build, build)
    rows = timed("k1", phase_k1, convseg, F)
    sl = timed("slice", phase_slice, models, sliding, convseg, smi)
    sl_wide = timed("slice_wide", phase_slice, models, sliding, convseg, smi,
                    fwd_wide=True)
    k2_rows = timed("k2", phase_k2, convseg)
    k10_rows = timed("k10", phase_k10, convseg, F)
    k3_rows = timed("k3", phase_k3, densemm, F, convseg)
    k4_rows = timed("k4", phase_k4, poolconv, F, convseg)
    labels = timed("labels", phase_labels, distance, boundary)
    labels.update(timed("labels_tiled", phase_labels_tiled, distance,
                        boundary))
    mods = (convseg, densemm, poolconv, distance, boundary)
    tr = timed("train", phase_train, models, mods, smi)
    paths = {"train": tr["launches"]}
    for patch, batch, steps in TRAIN_LARGE:
        paths[f"train_{patch}"] = timed(
            f"train_{patch}", phase_train_large, models, mods, smi, patch,
            batch, steps)["launches"]
    for name, row in timed("train_modes", phase_train_modes, models, mods,
                           smi).items():
        paths[name] = row["launches"]
    cli = timed("train_cli", phase_train_cli, mods, smi)
    paths["train_cli"] = {k: cli["run"]["launches"][k] +
                          cli["resume"]["launches"][k]
                          for k in cli["run"]["launches"]}
    amazon, k3_f32, k4_f32, labels_128 = timed("amazon", phase_amazon, mods,
                                               smi)
    paths["amazon"] = amazon["launches"]
    paths["amazon_steps"] = amazon["warm_steps"]["launches"]
    labels.update(labels_128)
    paths["viz"] = timed("viz", phase_viz, mods, smi)["launches"]
    variants = timed("variants", phase_variants, mods, smi)
    paths["variants_v1"] = variants["v1"]["launches"]
    paths["variants_legacy"] = {
        k: v + variants["legacy"]["predict_launches"][k]
        for k, v in variants["legacy"]["launches"].items()}
    remat = timed("remat_1024", phase_remat_1024, models, mods, smi)
    paths["remat_1024_plain"] = remat["plain"]["launches"]
    paths["remat_1024"] = remat["remat"]["launches"]
    dist, dist_tms, dist_ov = timed("dist", phase_dist, smi)
    for r, tm in enumerate(dist_tms):     # each rank's own counts
        paths[f"dist_rank{r}"] = {k: v + tm["counts"][k] + dist_ov[r][k]
                                  for k, v in
                                  dist["launches_by_rank"][r].items()}
    space = timed("space", phase_space, smi)
    for name, run in space["runs"].items():
        for r, counts in enumerate(run["launches_by_rank"]):
            paths[f"space_{name}_rank{r}"] = counts
    paths["trajectory"] = timed("trajectory", phase_trajectory, mods,
                                smi)["launches"]
    paths["quickstart"] = timed("quickstart", phase_quickstart, mods,
                                smi)["launches"]
    emit({"phase_seconds": phase_s})

    def launched(key):
        """Launches of a kernel on each train path that ran it, and in
        all."""
        by = {p: c[key] for p, c in paths.items() if c[key]}
        return sum(by.values()), by

    def per(rows_, launches_key):
        """Sums over the main path's calls at their shapes, and which of
        bytes and operations bounds the sum."""
        out = {k: sum(r[k] * r[launches_key] for r in rows_)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops_ms = sum(r["gflop"] * 1e9 / r.get("peak_flops", PEAK_BF16_FLOPS)
                     * 1e3 * r[launches_key] for r in rows_)
        bytes_ms = sum(r["mbytes"] * 1e6 / PEAK_BYTES * 1e3 *
                       r[launches_key] for r in rows_)
        out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        return out

    fwd = per([r for r in rows if r["on_path"]], "launches_per_forward")
    narrow = [r for r in k2_rows if r["path"] == "train"]
    bwd = per(narrow, "calls_per_step")
    k1_train, k1_by = launched("K1")
    k2_all, k2_by = launched("K2")
    k9_all, k9_by = launched("K9")
    # K2's counter holds K9's launches too
    k2_all -= k9_all
    k2_by = {p: n - k9_by.get(p, 0) for p, n in k2_by.items()
             if n - k9_by.get(p, 0)}
    kernels = [{
        "name": "K1 bn_act_conv (fused BN affine -> ReLU -> dilated 3x3 "
                "conv)",
        "route": "cuda",
        "source": "resuneta_torch/kernels/csrc/convseg.cu",
        "replaces": "resuneta_tpu/ops/pallas/convseg.py:550",
        "launches": sl["k1_launches"] + sl_wide["k1_launches"] + k1_train,
        "launches_by_path": {"slice": sl["k1_launches"],
                             "slice_wide": sl_wide["k1_launches"], **k1_by},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "tolerance": rows[0]["tolerance"],
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "per": "one 32-patch forward: the 44 launches at their shapes",
        "designs": {d: sorted({r["C"] for r in rows if r["design"] == d})
                    for d in sorted({r["design"] for r in rows})},
    }, {
        "name": "K2 segment_bwd (one-pass backward of the fused segment: "
                "dgrad, wgrad, BN sums)",
        "route": "cuda",
        "source": "resuneta_torch/kernels/csrc/convseg_bwd.cu",
        "replaces": "resuneta_tpu/ops/pallas/convseg.py:611",
        "launches": k2_all, "launches_by_path": k2_by,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows
                           if r["kernel"] == "K2"),
        "tolerance": k2_rows[0]["tolerance"],
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "library": "cuDNN convolution_backward of a precomputed bf16 z "
                   "(no BN sums)",
        "calls": launched("K2 calls")[0],
        "per": "one 16-patch 256 px train step: the 44 calls (4 launches "
               "each) at their shapes",
        "act_false": {k: v for r in k2_rows if not r["act"] for k, v in
                      r.items() if k in ("C", "H", "N", "d", "ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "calls_per_step")},
    }]
    wide = {p: per([r for r in k2_rows if r["path"] == p],
                   "calls_per_step")
            for p in ("train_wide", "train_wide_512", "train_wide_1024")}
    k9_fwd = {p: per([r for r in rows if r["path"] == p],
                     "launches_per_unit")
              for p in ("slice_wide", "train_wide", "train_wide_1024")}
    k10 = per(k10_rows, "calls_per_step")
    wide_kernels = [{
        "name": "K9 segment_bwd at C = 256 (the wide tier's one-pass "
                "backward: K2's TMA-fed wgmma dgrad and wgrad, each work "
                "item one 128-channel half of N, BN sums); its forward is "
                "K1's kernel",
        "route": "cuda",
        "source": "resuneta_torch/kernels/csrc/convseg_bwd.cu",
        "replaces": "resuneta_tpu/ops/pallas/convseg.py:611 (wide tier, "
                    "RESUNETA_CONVSEG_BWD_WIDE=1)",
        "launches": k9_all, "launches_by_path": k9_by,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows
                           if r["kernel"] == "K9"),
        "tolerance": TOLERANCE,
        **{k: wide["train_wide_1024"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "cuDNN convolution_backward of a precomputed bf16 z "
                   "(no BN sums)",
        "per": "one 2-patch 1024 px bwd_wide train step: the 12 calls at "
               "C = 256, 128^2 (4 launches each)",
        "at_256": wide["train_wide"], "at_512": wide["train_wide_512"],
        "forward_k1": k9_fwd,
    }, {
        "name": "K10 FusedSegmentBwdOnly (segment mode 2: a plain BN "
                "apply -> ReLU -> cuDNN conv forward, the K2 backward)",
        "route": "cuda",
        "source": "resuneta_torch/kernels/csrc/convseg_bwd.cu",
        "replaces": "resuneta_tpu/ops/pallas/convseg.py:763 "
                    "(fused_segment_bwdonly; its kernel the pallas_call at "
                    ":611)",
        "launches": launched("K10")[0], "launches_by_path":
            launched("K10")[1],
        "max_abs_err": max(r["max_abs_err"] for r in k10_rows),
        "tolerance": TOLERANCE,
        "ms": k10["ms"], "plain_ms": k10["plain_ms"],
        "bound_ms": k10["bound_ms"], "bound_by": k10["bound_by"],
        "library_ms": k10["library_ms"],
        "library": k10_rows[0]["library"],
        "per": "one 16-patch 256 px train step in segment mode 2: the 44 "
               "segments' forward and backward (4 K2 launches each) at "
               "their shapes",
    }]
    for key, krows, f32_rows, name, src, rep in (
            ("K3", k3_rows, k3_f32, "K3 dense_mm (1x1 conv over concat "
             "parts: ReLU, nearest upsample, stride fused; forward and "
             "backward)",
             "resuneta_torch/kernels/csrc/densemm.cu",
             "resuneta_tpu/ops/pallas/densemm.py:321"),
            ("K4", k4_rows, k4_f32, "K4 pool_conv (k x k max pool -> 1x1 "
             "conv; forward and the tie-splitting backward)",
             "resuneta_torch/kernels/csrc/poolconv.cu",
             "resuneta_tpu/ops/pallas/poolconv.py:237")):
        for r in krows + f32_rows:       # both ways of a call, once a step
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                r[k] = r[k + "_fwd"] + r[k + "_bwd"]
        tot = per(krows, "calls_per_step")
        at128 = per(f32_rows, "calls_per_step")
        fwd_n, fwd_by = launched(key)
        bwd_n, bwd_by = launched(key + " bwd")
        bwd_launches = ("3 launches a call, 4 with an upsampled part"
                        if key == "K3" else "2 launches a call")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": fwd_n + bwd_n,
            "launches_by_way": {"forward": fwd_n, "backward": bwd_n},
            "launches_by_path": {p: fwd_by[p] + bwd_by[p] for p in fwd_by},
            "calls": {"forward": launched(key + " calls")[0],
                      "backward": launched(key + " bwd calls")[0]},
            "max_abs_err": max(r["max_abs_err"] for r in krows + f32_rows),
            "tolerance": krows[0]["tolerance"], "design": krows[0]["design"],
            "share_of_bound": tot["bound_ms"] / tot["ms"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"],
            "library": krows[0].get(
                "library", "cuDNN 1x1 conv and convolution_backward of the "
                           "materialised concat/upsample"),
            "per": f"one 16-patch 256 px dense-trunk train step: the "
                   f"{len(krows)} calls at their shapes, forward (1 launch "
                   f"a call) and backward ({bwd_launches})",
            "f32_at_128": {
                **at128, "share_of_bound": at128["bound_ms"] / at128["ms"],
                "design": f32_rows[0]["design"],
                "max_abs_err": max(r["max_abs_err"] for r in f32_rows),
                "per": f"one 8-patch 128 px f32 Amazon step: the "
                       f"{len(f32_rows)} calls at their shapes, both ways"}})
    for key, row_key, name, src, rep, unit in (
            ("K5/K7", "k5", "K5/K7 distance_transform_edt (JFA exact EDT: "
             "a whole plane in a thread block cluster's shared memory, one "
             "launch; larger planes banded large-step passes and a fused "
             "small-step tail; the planes of both TPU kernels)",
             "resuneta_torch/kernels/csrc/jfa.cu",
             "resuneta_tpu/ops/pallas/jfa.py:291",
             "one 16-patch 256 px train step: one call of one launch over "
             "80 planes of 256^2 (at_512: one call of 8 launches over 40 "
             "planes of 512^2, an 8-patch 512 px step; at_1024: one of 9 "
             "over 10 planes of 1024^2, a 2-patch 1024 px step)"),
            ("K6", "k6", "K6 boundary_label (Canny(0,1) + cross dilation: "
             "a tiled stencil pass, then the hysteresis pass, which "
             "computes only flagged planes)",
             "resuneta_torch/kernels/csrc/canny.cu",
             "resuneta_tpu/ops/pallas/canny.py:227",
             "one 16-patch 256 px train step: one call of 2 launches over 80 "
             "planes of 256^2"),
            ("K8", "k8_512", "K8 boundary_label, row-tiled (Canny(0,1) + "
             "cross dilation: the tiled stencil pass, then the hysteresis "
             "pass per band of rows, 35-row halo, on flagged planes only)",
             "resuneta_torch/kernels/csrc/canny.cu",
             "resuneta_tpu/ops/pallas/canny.py:257",
             "one 8-patch 512 px train step: one call of 2 launches over 40 "
             "planes of 512^2 (at_1024: a 2-patch 1024 px step, 10 planes of "
             "1024^2)")):
        r = labels[row_key]
        n, by = launched(key)
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "launches_by_path": by,
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "library": r["library"], "per": unit}
        sizes = {"K5/K7": (("at_512", "k5_512"), ("at_1024", "k7")),
                 "K8": (("at_1024", "k8_1024"),), "K6": ()}[key]
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "design",
                  "launches_per_call", "share_of_bound") + (
            ("ms_by_design",) if key == "K5/K7" else ("tile", "ms_by_tile"))
        for at, k in sizes:
            entry[at] = {f: labels[k][f] for f in fields}
        if key != "K8":          # the Amazon step's 28 planes of 128^2
            at128 = labels[row_key + "_128"]
            entry["at_128"] = {f: at128[f] for f in (
                "planes", "ms", "plain_ms", "bound_ms", "bound_by", "design",
                "launches_per_call", "share_of_bound", "max_abs_err") + (
                ("cluster_blocks",) if key == "K5/K7" else ())}
        entry.update({f: r[f] for f in ("design", "share_of_bound",
                                        "launches_per_call")})
        if key == "K5/K7":
            entry["also_replaces"] = "resuneta_tpu/ops/pallas/jfa.py:221"
            entry["ms_by_design"] = labels["k5_layouts_256"]["ms_by_design"]
        kernels.append(entry)
    emit({"kernels": kernels + wide_kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
