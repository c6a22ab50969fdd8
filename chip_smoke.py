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
4. kernels line, then the last line {"ok": true, "device": {...}}.

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from resuneta_torch import models
    from resuneta_torch.infer import sliding
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import convseg

    torch.manual_seed(SEED)
    smi = phase_build(build)
    rows = phase_k1(convseg, F)
    sl = phase_slice(models, sliding, convseg, smi)

    per_fwd = [r for r in rows if r["on_path"]]
    fwd = {k: sum(r[k] * r["launches_per_forward"] for r in per_fwd)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    ops_ms = sum(r["gflop"] * 1e9 / PEAK_BF16_FLOPS * 1e3 *
                 r["launches_per_forward"] for r in per_fwd)
    bytes_ms = sum(r["mbytes"] * 1e6 / PEAK_BYTES * 1e3 *
                   r["launches_per_forward"] for r in per_fwd)
    emit({"kernels": [{
        "name": "K1 bn_act_conv (fused BN affine -> ReLU -> dilated 3x3 "
                "conv)",
        "route": "cuda",
        "source": "resuneta_torch/kernels/csrc/convseg.cu",
        "replaces": "resuneta_tpu/ops/pallas/convseg.py:550",
        "launches": sl["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "tolerance": rows[0]["tolerance"],
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": fwd["library_ms"],
        "per": "one 32-patch forward: the 44 launches at their shapes",
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
