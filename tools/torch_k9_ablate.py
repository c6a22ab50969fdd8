#!/usr/bin/env python3
"""What paces K9 (the C = 256 segment backward) on the card: each kernel's
device time in copies of the package with one part of the work taken out
or one choice of the design changed.

    python3 tools/torch_k9_ablate.py [--out FILE]

Each variant is a copy of `resuneta_torch/` under `build/k9_ablate/<name>`
whose `kernels/csrc/convseg_bwd.cu` has one change made by a text
substitution (the ablations' results are wrong, and only the times are
read); the copies build together, then each runs in its own process,
twice, in turns. For the C = 256 rows of `chip_smoke.K2_SHAPES` (the
bwd_wide steps' RB(256) segments at 32^2 x 16, 64^2 x 8 and 128^2 x 2, d
= 1, 3, 15) it prints the device time of tma_dgrad_kernel,
tma_wgrad_kernel and the two sums (torch.profiler, 10 calls after 3),
summed over the 12 calls of a step at each plane, one JSON line per run,
the card first.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("resuneta_torch", "kernels", "csrc", "convseg_bwd.cu")
DG_MMA = "sm90::wgmma<NC, 0, 1>(acc, da, db);"
DG_EPI = "for (int r = tid / CPR; r < S::PIX; r += RPP) {"
DG_HALO = "int halo = bw >= 64 && bw + 2 * d <= 256;"
WG_MMA = "sm90::wgmma<NC, 1, 1>(acc, da, db);"
WG_CHUNKS = "S::NH > 1 ? SMS / S::YS"
WG_RING = ("uint64_t full[4], empty[4];\n\n  const int tid = threadIdx.x, "
           "warp = tid >> 5, lane = tid & 31;\n  const int stage_bytes = "
           "S::NB")
# name -> [(text, its replacement, occurrences)]
VARIANTS = {
    "as_is": [],
    "dgrad_no_wgmma": [(DG_MMA, "if (d < 0) " + DG_MMA, 2)],
    "dgrad_no_epilogue": [(DG_EPI, DG_EPI.replace("r < S::PIX", "r < 0"),
                           1)],
    "dgrad_box_a_tap": [(DG_HALO, "int halo = 0;", 1)],
    "wgrad_no_wgmma": [(WG_MMA, "if (d < 0) " + WG_MMA, 1)],
    "wgrad_two_waves": [(WG_CHUNKS, "S::NH > 1 ? 2 * SMS / S::YS", 1)],
    "wgrad_six_stages": [(WG_RING, WG_RING.replace("[4]", "[8]"), 1),
                         ("int wstages = 4;", "int wstages = 6;", 1)],
}
KERNELS = ("tma_dgrad_kernel", "tma_wgrad_kernel", "reduce_rows",
           "reduce_cols")


def run_one(pkg):
    """Device ms of K9's kernels a step at each plane, on the package copy
    at pkg (the repo's chip_smoke for the shapes and inputs)."""
    sys.path.insert(0, pkg)
    sys.path.insert(1, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from resuneta_torch.ops import convseg

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
    out = {}
    for C, S, N, d, act, path, calls in chip_smoke.K2_SHAPES:
        if C != 256:
            continue
        x, gr, gamma, beta, mean, var, w = chip_smoke.segment_inputs(
            g, N, S, C)
        a, b, invstd = convseg.segment_affine(gamma, beta, mean, var)
        args = (x, gr, a, b, mean, invstd, w)
        for _ in range(3):
            convseg.segment_bwd(*args, dilation=d, act=act)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                convseg.segment_bwd(*args, dilation=d, act=act)
            torch.cuda.synchronize()
        ms = out.setdefault(path, {k: 0.0 for k in KERNELS})
        for e in prof.key_averages():
            for k in KERNELS:
                if k in e.key:
                    ms[k] += e.device_time_total / 1e3 / 10 * calls
    for ms in out.values():
        ms["total"] = sum(ms[k] for k in KERNELS)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one)), flush=True)
        return
    os.chdir(HERE)
    src = open(SRC).read()
    for name, subs in VARIANTS.items():
        d = os.path.join("build", "k9_ablate", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree("resuneta_torch", os.path.join(d, "resuneta_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        text = src
        for old, new, count in subs:
            if text.count(old) != count:
                raise SystemExit(f"{name}: {old!r} occurs "
                                 f"{text.count(old)} times in "
                                 f"convseg_bwd.cu, not {count}")
            text = text.replace(old, new)
        with open(os.path.join(d, SRC), "w") as f:
            f.write(text)
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "from resuneta_torch.kernels import build; "
         "build.build_all(['convseg_bwd'])"],
        cwd=os.path.join("build", "k9_ablate", n), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in VARIANTS}
    for n, p in builds.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n}: build failed\n{log[-3000:]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lines = []
    for rep in range(2):
        for n in VARIANTS:
            pkg = os.path.abspath(os.path.join("build", "k9_ablate", n))
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--one", pkg], capture_output=True,
                                 text=True)
            if res.returncode:
                raise SystemExit(f"{n}: run failed\n{res.stderr[-3000:]}")
            line = json.dumps({"variant": n, "run": rep,
                               "ms": json.loads(res.stdout.splitlines()[-1])})
            print(line, flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
