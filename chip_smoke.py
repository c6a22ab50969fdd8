#!/usr/bin/env python3
"""Drive the PyTorch port (resuneta_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. build  - compile every CUDA kernel from resuneta_torch/kernels/csrc into
            build/kernels/ (one nvcc per source, started together) and print
            the card's name and power limit as nvidia-smi gives them.
2. k1     - K1 (fused BN affine -> ReLU -> dilated 3x3 conv) against its
            plain PyTorch version on the card, in bf16, at every shape the
            256 px inference path gives it (batch 32) plus the C=256 wide
            shape; times the kernel, the plain version and one cuDNN bf16
            conv of the same z (library_ms, a yardstick the port never
            calls) beside the least time the card could take (bound_ms).
3. slice  - ISPRS whole-scene inference of ResUnet-a d6 at full width
            (5 classes, 256 px, multitask, bf16, seeded random weights): a
            2048x2048 uint8 scene through predict_scene(make_seg_ids_fn(...),
            ids_only=True), batch 32. Checks the ids, that K1 launched 44
            times per batch, and one patch's seg probabilities (f32 model,
            card against the CPU plain path); times a warm second pass.
4. k2     - K2 (the segment's one-pass backward) against its plain version
            at the 11 shapes of the 256 px train step (batch 16, bf16): the
            seven cotangents it folds into; times the kernel, the plain
            version and one cuDNN convolution_backward (dgrad + wgrad +
            bias, no BN sums) of the same precomputed bf16 z and g
            (library_ms).
5. k5, k6 - the JFA distance transform and the Canny boundary kernels
            against their plain versions, bit for bit, on the 80 planes of
            256^2 a 16 x 5-class batch gives them (Voronoi blobs, uniform
            noise, an all-zero and an all-one plane); no PyTorch call
            computes either, so library_ms is null.
6. train  - the ISPRS multitask train step at full width (bf16, batch 16,
            256 px, Adam 1e-4, Tanimoto on the four heads, uint8 patches and
            Voronoi-blob class ids through make_device_pipeline): per
            step 44 K1 launches, 44 K2 calls of 4 launches, one K5 call of
            13 launches and one K6 launch; finite metric rows; the loss
            after 10 steps on one batch below the first step's. Times the
            warm steps (median, with a synchronise). Then one 64 px, bs 2,
            f32 step, card against the CPU plain path, beside the CPU with
            one thread against many (step_card_vs_cpu; the card's step
            test in tests/test_torch_gpu.py runs the same function).
7. kernels line, then the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, where torch.cuda.is_available() is false
or the package is not beside this file.
"""

import json
import math
import subprocess
import sys
import time

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
# dilations in each; C=256 is the opt-in wide tier (K9), held but not routed
K1_LEVELS = ((32, 256, (1, 3, 15, 31)), (64, 128, (1, 3, 15, 31)),
             (128, 64, (1, 3, 15)))
K9_SHAPE = (256, 32, (1,))
K1_RTOL = K1_ATOL = 0.02
SEG_ATOL = 1e-2
# the train step: batch, steps on one batch, heads
TRAIN_BATCH = 16
TRAIN_STEPS = 10
HEADS = ("seg", "bound", "dist", "color")
# K2 against its plain version, on the seven cotangents: dx (bf16) within
# one bf16 ulp (2^-7 relative) plus 1e-3 of its largest magnitude; the
# others (dW and what the BN sums fold into) within 1e-3 of their largest
# magnitude (f32 sums over up to 10^6 pixels in another order)
K2_RTOL = 2 ** -7
K2_ATOL_OF_MAX = 1e-3
# non-tensor-core peak (the 67 TFLOP/s f32 figure of the same data sheet),
# the rate the integer work of K5 and K6 is held against
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
# its S1 and S2) is held on its own, within 0.1 relative L2: twice the
# card's reading (0.048 on an H100) and 2.7x what the CPU alone shows
# between one thread and eight (0.037); a K2 that dropped dW reads 1
STEP_TOL = {"loss_rel": 2e-3, "grads_rel_l2": 0.1, "heads_rel_l2": 3e-2,
            "bn_running_rel_l2": 5e-3, "last_block_rel_l2": 0.1}
HEAD_LEAVES = ("seg1", "seg2", "seg3", "Conv_6", "Conv_7", "Conv_9",
               "Conv_10", "Conv_11")
LAST_BLOCK = "ResBlockA_10"


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


def k1_bound(N, H, W, C, itemsize=2):
    flops = 2 * 9 * C * C * H * W * N
    nbytes = 2 * N * H * W * C * itemsize + 9 * C * C * 4 + 4 * C * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_k1(convseg, F):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    shapes = [(C, S, d, True) for C, S, ds in K1_LEVELS for d in ds] + \
        [(K9_SHAPE[0], K9_SHAPE[1], d, False) for d in K9_SHAPE[2]]
    for C, S, d, on_path in shapes:
        N = BATCH
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
               "on_path": on_path, "max_abs_err": max_err,
               "tolerance": f"|err| <= {K1_ATOL} + {K1_RTOL}*|plain|",
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               # 2 segments per dilation, in the encoder and decoder block
               "launches_per_forward": 4 if on_path else 0}
        emit(row)
        rows.append(row)
        del x, got, want, z, err
    return rows


def phase_slice(models, sliding, convseg, smi):
    rng = np.random.default_rng(SEED)
    scene = rng.integers(0, 256, (SCENE, SCENE, 3), dtype=np.uint8)
    model = models.ResUnetA(NUM_CLASSES, img_size=PATCH, multitasking=True,
                            dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(SEED))
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
    if launches != 44 * n_batches:
        fail(f"K1 launched {launches} times, expected {44 * n_batches}")
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
                          device="cpu")
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

    row = {"phase": "slice", "model": "ResUnetA d6 multitask",
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
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_k2(convseg):
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for C, S, ds in K1_LEVELS:
        for d in ds:
            N = TRAIN_BATCH
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
            a, b, invstd = convseg.segment_affine(gamma, beta, mean, var)
            args = (x, gr, a, b, mean, invstd, w)

            # the seven cotangents (dx, dgamma, dbeta, dmean, dvar, dW, dbias)
            got = convseg.fold_cotangents(
                *convseg.segment_bwd(*args, dilation=d), gamma, invstd)
            want = convseg.fold_cotangents(
                *convseg.segment_bwd_reference(*args, dilation=d), gamma,
                invstd)
            torch.cuda.synchronize()
            max_err = 0.0
            for k, (gt, wt) in enumerate(zip(got, want)):
                gt, wt = gt.float(), wt.float()
                err = (gt - wt).abs()
                lim = K2_ATOL_OF_MAX * wt.abs().max() + \
                    (K2_RTOL * wt.abs() if k == 0 else 0)
                if not torch.isfinite(gt).all() or not bool(
                        torch.all(err <= lim)):
                    fail(f"K2 output {k} disagrees with its plain version "
                         f"at C={C} {S}x{S} d={d}: max abs err "
                         f"{err.max().item()}")
                max_err = max(max_err, err.max().item())

            # library yardstick: cuDNN's dgrad + wgrad + bias of the same
            # precomputed bf16 z and g (no BN sums, no mask, no dx scaling)
            z = torch.relu(x.float() * a + b).to(torch.bfloat16) \
                .permute(0, 3, 1, 2)
            gl = gr.permute(0, 3, 1, 2)
            wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            ms = cuda_ms(lambda: convseg.segment_bwd(*args, dilation=d),
                         reps=10)
            lib_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                gl, z, wl, [C], [1, 1], [d, d], [d, d], False, [0, 0], 1,
                [True, True, True]), reps=10)
            plain_ms = cuda_ms(lambda: convseg.segment_bwd_reference(
                *args, dilation=d), reps=3, warmup=1)
            bound_ms, bound_by, flops, nbytes = k2_bound(N, S, S, C)
            row = {"phase": "k2", "N": N, "H": S, "W": S, "C": C, "d": d,
                   "max_abs_err": max_err,
                   "tolerance": f"|err| <= {K2_ATOL_OF_MAX}*max|plain| "
                                f"(+ {K2_RTOL}*|plain| for dx)",
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                   "calls_per_step": 4}
            emit(row)
            rows.append(row)
            del x, gr, got, want, z, gl
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


def label_planes():
    """80 int32 planes of 256^2: 14 samples x 5 classes of Voronoi blobs,
    8 of uniform noise, an all-zero and an all-one plane."""
    rng = np.random.default_rng(SEED + 5)
    ids = voronoi_ids(14, PATCH, NUM_CLASSES, rng)
    blobs = np.eye(NUM_CLASSES, dtype=np.int32)[ids].transpose(0, 3, 1, 2)
    planes = np.concatenate([
        blobs.reshape(-1, PATCH, PATCH),
        (rng.random((8, PATCH, PATCH)) < 0.5).astype(np.int32),
        np.zeros((1, PATCH, PATCH), np.int32),
        np.ones((1, PATCH, PATCH), np.int32)])
    return torch.from_numpy(planes).cuda()


def phase_labels(distance, boundary):
    """K5 and K6, bit for bit. Bound: 4 bytes in and 4 out a pixel, and the
    integer work the function needs counted against PEAK_SCALAR_OPS: K5
    ~100 operations a pixel per JFA pass (8 candidates: bounds, the seed's
    unpacking, d^2, compare and select), K6 ~50 a pixel (Sobel, NMS,
    thresholds, cross dilation; these class planes need no hysteresis
    round)."""
    planes = label_planes()
    P, H, W = planes.shape
    rows = {}
    for name, mod, fn, ref, ops_px in (
            ("k5", distance, distance.distance_transform_edt,
             distance.distance_transform_edt_reference,
             100 * len(distance.jfa_steps(H, W))),
            ("k6", boundary, boundary.boundary_label,
             boundary.boundary_label_reference, 50)):
        got = fn(planes)
        want = ref(planes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"{name} differs from its plain version at {bad} pixels")
        ms = cuda_ms(lambda: fn(planes), reps=10)
        plain_ms = cuda_ms(lambda: ref(planes), reps=2, warmup=1)
        t_ops = P * H * W * ops_px / PEAK_SCALAR_OPS
        t_bytes = P * H * W * 8 / PEAK_BYTES
        row = {"phase": name, "planes": P, "H": H, "W": W,
               "max_abs_err": 0.0, "tolerance": "bit-identical",
               "ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "library": "none: no PyTorch call computes this function",
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ops_per_pixel": ops_px,
               "nonzero_share": got.gt(0).float().mean().item()}
        emit(row)
        rows[name] = row
    return rows


def rel_l2(a, b, atol=1e-6):
    """Relative L2 with an absolute floor (tests/test_train_parity.py:
    113-120): a conv bias straight before a BN has a zero gradient, and
    both sides give noise there."""
    d = (a - b).norm().item()
    return 0.0 if d <= atol else d / max(b.norm().item(), 1e-12)


def step_64px(device, raw):
    """One 64 px, bs 2, f32 train step from seeded weights on `device`: the
    metrics row, every parameter's gradient and every BN running buffer, in
    f64 on the CPU."""
    from resuneta_torch import losses, models
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.train import create_train_state, make_train_step

    model = models.ResUnetA(NUM_CLASSES, img_size=64, dtype=torch.float32,
                            generator=torch.Generator().manual_seed(SEED + 7),
                            device=device)
    state = create_train_state(model, "adam", 1e-4)
    step = make_train_step(losses.make_losses("tanimoto"),
                           {h: 1.0 for h in HEADS}, True,
                           preprocess=make_device_pipeline(NUM_CLASSES, 1,
                                                           device=device),
                           device=device)
    _, row = step(state, raw)
    grads = {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()}
    bufs = {k: v.detach().cpu().double() for k, v in model.named_buffers()}
    return row.cpu().double(), grads, bufs


def step_errors(got, want):
    """The readings STEP_TOL holds, of one 64 px step against another."""
    (rg, gg, bg), (rw, gw, bw) = got, want
    a = torch.cat([g.ravel() for g in gg.values()])
    b = torch.cat([g.ravel() for g in gw.values()])
    return {
        "loss_rel": ((rg[:5] - rw[:5]).abs() / rw[:5].abs()).max().item(),
        "grads_rel_l2": rel_l2(a, b, atol=0),
        "heads_rel_l2": max(rel_l2(gg[k], gw[k]) for k in gw
                            if k.split(".")[0] in HEAD_LEAVES),
        "last_block_rel_l2": max(rel_l2(gg[k], gw[k]) for k in gw
                                 if k.startswith(LAST_BLOCK + ".")),
        "bn_running_rel_l2": max(rel_l2(bg[k], bw[k]) for k in bw)}


def step_card_vs_cpu():
    """The 64 px, bs 2, f32 step on the card (TF32 off) against the CPU
    plain path, from the same weights and batch, and the CPU with one
    thread against the CPU with many, the same readings of the order of
    sums alone. Returns the readings, the kernel launches of the card's
    step, and the names of the readings past STEP_TOL."""
    from resuneta_torch.ops import boundary, convseg, distance

    rng = np.random.default_rng(SEED + 4)
    raw = {"image_u8": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
           "label_ids": voronoi_ids(2, 64, NUM_CLASSES, rng),
           "aug": np.array([0, 3])}
    cpu = step_64px("cpu", raw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu1 = step_64px("cpu", raw)
    finally:
        torch.set_num_threads(threads)
    counters = ((convseg, "LAUNCHES"), (convseg, "BWD_LAUNCHES"),
                (distance, "LAUNCHES"), (boundary, "LAUNCHES"))
    before = [getattr(m, k) for m, k in counters]
    with convseg.no_tf32():
        card = step_64px("cuda", raw)
    torch.cuda.synchronize()
    launches = dict(zip(("K1", "K2", "K5", "K6"),
                        (getattr(m, k) - c for (m, k), c in
                         zip(counters, before))))
    errs = step_errors(card, cpu)
    return {"card_vs_cpu": errs,
            "cpu_1_vs_{}_threads".format(threads): step_errors(cpu1, cpu),
            "tolerance": STEP_TOL, "launches": launches,
            "failed": [k for k, v in errs.items() if not v < STEP_TOL[k]]}


def phase_train(models, convseg, distance, boundary, smi):
    from resuneta_torch import losses
    from resuneta_torch.data import make_device_pipeline
    from resuneta_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED + 3)
    raw = {"image_u8": rng.integers(0, 256, (TRAIN_BATCH, PATCH, PATCH, 3),
                                    dtype=np.uint8),
           "label_ids": voronoi_ids(TRAIN_BATCH, PATCH, NUM_CLASSES, rng),
           "aug": rng.integers(0, 5, TRAIN_BATCH)}
    model = models.ResUnetA(NUM_CLASSES, img_size=PATCH, multitasking=True,
                            dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(model, "adam", 1e-4)
    step = make_train_step(losses.make_losses("tanimoto"),
                           {h: 1.0 for h in HEADS}, True,
                           preprocess=make_device_pipeline(NUM_CLASSES, 1))

    convseg.LAUNCHES = convseg.BWD_LAUNCHES = convseg.BWD_CALLS = 0
    distance.LAUNCHES = boundary.LAUNCHES = 0
    rows, times = [], []
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        state, row = step(state, raw)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        rows.append(row.cpu().numpy())
    launches = {"K1": convseg.LAUNCHES, "K2": convseg.BWD_LAUNCHES,
                "K5": distance.LAUNCHES, "K6": boundary.LAUNCHES}
    k2_calls = convseg.BWD_CALLS
    peak = torch.cuda.max_memory_allocated()
    # per step: 44 fused segments, each one K1 launch forward and one K2
    # call (4 launches) backward; one K5 call (a launch per JFA pass + 2)
    # and one K6 launch over the batch's 80 class planes
    want = {"K1": 44 * TRAIN_STEPS, "K2": 4 * 44 * TRAIN_STEPS,
            "K5": (len(distance.jfa_steps(PATCH, PATCH)) + 2) * TRAIN_STEPS,
            "K6": TRAIN_STEPS}
    if launches != want or k2_calls != 44 * TRAIN_STEPS:
        fail(f"train launches {launches} and {k2_calls} K2 calls, expected "
             f"{want} and {44 * TRAIN_STEPS}")
    rows = np.stack(rows)
    if not np.isfinite(rows).all():
        fail(f"non-finite metric rows: {rows}")
    if not rows[-1, 0] < rows[0, 0]:
        fail(f"loss did not fall over {TRAIN_STEPS} steps on one batch: "
             f"{rows[:, 0]}")

    warm = sorted(times[1:])
    median = warm[len(warm) // 2]
    row = {"phase": "train", "model": "ResUnetA d6 multitask",
           "params": sum(p.numel() for p in model.parameters()),
           "patch": PATCH, "batch": TRAIN_BATCH, "dtype": "bfloat16",
           "optimizer": "adam 1e-4", "loss": "tanimoto x 4 heads",
           "steps": TRAIN_STEPS, "launches": launches,
           "k2_calls": k2_calls,
           "first_step_s": times[0], "step_s": times,
           "median_warm_step_s": median,
           "patches_per_s": TRAIN_BATCH / median,
           "max_memory_allocated_bytes": peak,
           "loss_first": float(rows[0, 0]), "loss_last": float(rows[-1, 0]),
           "row_first": rows[0].tolist(), "row_last": rows[-1].tolist(),
           "card": smi}
    emit(row)
    parity = step_card_vs_cpu()
    emit({"phase": "train_64px_f32", **parity})
    if parity["failed"]:
        fail(f"64 px step, card vs CPU: {parity['failed']} past their "
             f"limits: {parity['card_vs_cpu']} against {STEP_TOL}")
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
    from resuneta_torch.ops import boundary, convseg, distance

    torch.manual_seed(SEED)
    smi = phase_build(build)
    rows = phase_k1(convseg, F)
    sl = phase_slice(models, sliding, convseg, smi)
    k2_rows = phase_k2(convseg)
    labels = phase_labels(distance, boundary)
    tr = phase_train(models, convseg, distance, boundary, smi)

    def per(rows_, launches_key):
        """Sums over the main path's calls at their shapes, and which of
        bytes and operations bounds the sum."""
        out = {k: sum(r[k] * r[launches_key] for r in rows_)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops_ms = sum(r["gflop"] * 1e9 / PEAK_BF16_FLOPS * 1e3 *
                     r[launches_key] for r in rows_)
        bytes_ms = sum(r["mbytes"] * 1e6 / PEAK_BYTES * 1e3 *
                       r[launches_key] for r in rows_)
        out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        return out

    fwd = per([r for r in rows if r["on_path"]], "launches_per_forward")
    bwd = per(k2_rows, "calls_per_step")
    kernels = [{
        "name": "K1 bn_act_conv (fused BN affine -> ReLU -> dilated 3x3 "
                "conv)",
        "route": "cuda",
        "source": "resuneta_torch/kernels/csrc/convseg.cu",
        "replaces": "resuneta_tpu/ops/pallas/convseg.py:550",
        "launches": sl["k1_launches"] + tr["launches"]["K1"],
        "launches_by_path": {"slice": sl["k1_launches"],
                             "train": tr["launches"]["K1"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "tolerance": rows[0]["tolerance"],
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "per": "one 32-patch forward: the 44 launches at their shapes",
    }, {
        "name": "K2 segment_bwd (one-pass backward of the fused segment: "
                "dgrad, wgrad, BN sums)",
        "route": "cuda",
        "source": "resuneta_torch/kernels/csrc/convseg_bwd.cu",
        "replaces": "resuneta_tpu/ops/pallas/convseg.py:611",
        "launches": tr["launches"]["K2"],
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "tolerance": k2_rows[0]["tolerance"],
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "library": "cuDNN convolution_backward of a precomputed bf16 z "
                   "(no BN sums)",
        "calls": tr["k2_calls"],
        "per": "one 16-patch train step: the 44 calls (4 launches each) at "
               "their shapes",
    }]
    for key, name, src, rep in (
            ("k5", "K5 distance_transform_edt (JFA exact EDT)",
             "resuneta_torch/kernels/csrc/jfa.cu",
             "resuneta_tpu/ops/pallas/jfa.py:291"),
            ("k6", "K6 boundary_label (Canny(0,1) + cross dilation)",
             "resuneta_torch/kernels/csrc/canny.cu",
             "resuneta_tpu/ops/pallas/canny.py:227")):
        r = labels[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": tr["launches"][key.upper()],
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "library": r["library"],
            "per": "one 16-patch train step: one call over 80 planes of "
                   "256^2 (K5: 13 launches, K6: one)"})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
