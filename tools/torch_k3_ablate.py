#!/usr/bin/env python3
"""What paces K3's bf16 kernels on the card: each kernel's device time in
copies of the package with one part of the work taken out.

    python3 tools/torch_k3_ablate.py [--out FILE]

Each variant is a copy of `resuneta_torch/` under `build/k3_ablate/<name>`
whose `kernels/csrc/densemm.cu` has one piece disabled by a text
substitution (the results are then wrong, and only the times are read);
the copies build together, then each runs in its own process, twice, in
turns. For the 1M-pixel calls of `chip_smoke.K3_CALLS` (the 256 px step
at batch 16) it prints the device time of k3_fwd_kernel, k3_dgrad_kernel,
k3_wgrad_kernel and k3_rowsum_kernel (torch.profiler, 10 calls after 3),
one JSON line per run, the card first.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("resuneta_torch", "kernels", "csrc", "densemm.cu")
CALLS = ("Combine_3", "Combine_4", "Combine_5", "PSPPooling_1 level 1",
         "PSPPooling_1 projection")
FORM = "        if (pt.ups > 1 || pt.act) {\n"
FWD_MMA = ("          mma<NP, 0>(acc, sm90::desc(As + kk * 32, 16, 8 * rb, "
           "layout(rb)), Bs + kk * 32,")
FWD_STORE = "          if (c < kp.cout) store2(dst + c,"
DG_EPI = "    for (int q = 0; q * CB < G.width; ++q) {\n"
DG_MASK = "        if (xoff >= 0)\n"
WG_MMA = "    if (pt)\n#pragma unroll\n      for (int kk = 0; kk < WPIX / 16; ++kk)"
# name -> [(text, its replacement)]
VARIANTS = {
    "as_is": [],
    "fwd_no_forming": [(FORM, "        if (false) {\n")],
    "fwd_no_wgmma": [(FWD_MMA, "          if (kk < 0) " + FWD_MMA.lstrip())],
    "fwd_no_stores": [(FWD_STORE, "          if (c < 0) store2(dst + c,")],
    "dgrad_no_epilogue": [(DG_EPI, "    for (int q = 0; q * CB < 0; ++q) {\n")],
    "dgrad_no_mask_reads": [(DG_MASK, "        if (false)\n")],
    "wgrad_no_wgmma": [(WG_MMA, WG_MMA.replace("if (pt)", "if (false)"))],
}


def run_one(pkg):
    """Device ms of K3's kernels for the CALLS, on the package copy at
    pkg (the repo's chip_smoke for the shapes and inputs)."""
    sys.path.insert(0, pkg)
    sys.path.insert(1, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from resuneta_torch.ops import densemm

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 8)
    out = {}
    for name, parts, cout in chip_smoke.K3_CALLS:
        if name not in CALLS:
            continue
        N, s0 = chip_smoke.TRAIN_BATCH, parts[0][4]
        H = parts[0][1] // s0 * parts[0][3]
        xs = [torch.randn((N, h, h, c), generator=g, device="cuda").to(
            torch.bfloat16) for c, h, _, _, _ in parts]
        cin = sum(p[0] for p in parts)
        w = torch.randn((cin, cout), generator=g, device="cuda") / cin ** 0.5
        b = torch.randn(cout, generator=g, device="cuda") * 0.1
        spec = {"acts": [p[2] for p in parts], "ups": [p[3] for p in parts],
                "strides": [p[4] for p in parts]}
        gr = torch.randn((N, H, H, cout), generator=g, device="cuda").to(
            torch.bfloat16)
        for _ in range(3):
            densemm.dense_mm_fwd(xs, w, b, **spec)
            densemm.dense_mm_bwd(xs, gr, w, **spec)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                densemm.dense_mm_fwd(xs, w, b, **spec)
                densemm.dense_mm_bwd(xs, gr, w, **spec)
            torch.cuda.synchronize()
        ms = {}
        for e in prof.key_averages():
            for k in ("fwd", "dgrad", "wgrad", "rowsum"):
                if f"k3_{k}_kernel" in e.key:
                    ms[k] = ms.get(k, 0.0) + e.device_time_total / 1e3 / 10
        out[name] = ms
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
        d = os.path.join("build", "k3_ablate", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree("resuneta_torch", os.path.join(d, "resuneta_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not "
                                 f"unique in densemm.cu: {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, SRC), "w") as f:
            f.write(text)
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "from resuneta_torch.kernels import build; "
         "build.build_all(['densemm'])"],
        cwd=os.path.join("build", "k3_ablate", n), stdout=subprocess.PIPE,
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
            pkg = os.path.abspath(os.path.join("build", "k3_ablate", n))
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
