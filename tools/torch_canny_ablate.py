#!/usr/bin/env python3
"""What paces pass 1 of the Canny boundary kernel (K6/K8,
kernels/csrc/canny.cu canny_tile_kernel): each variant changes one part
of a copy of canny.cu and times both passes by device time under
torch.profiler on the train steps' label planes (`chip_smoke.label_planes`:
80 x 256^2, 40 x 512^2, 10 x 1024^2) and on uniform-noise planes of the
same sizes, where no tile is of one value.

    python3 tools/torch_canny_ablate.py [--out FILE]

Variants: as_is; no_shortcut (a tile whose input is of one value runs the
stencil too); no_sobel (mag is the input value: Sobel's loads stay, its
arithmetic goes); no_nms (kept = mag > 3); no_stores (pass 1 stores no
output). The last three give wrong labels (and may flag planes, which
pass 2 then computes again: `pass2_us`); only pass 1's time counts. Each
copy of the package goes under build/canny_ablate/<name>/ (git-ignored)
and builds there. Prints the card, then one JSON line a variant: pass 1's
and pass 2's device microseconds a call, and whether the labels equal the
plain version's; --out also writes the lines to FILE.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("resuneta_torch", "kernels", "csrc", "canny.cu")
# (name, [(text of canny.cu, its replacement)]): each text occurs once
VARIANTS = (
    ("as_is", []),
    ("no_shortcut", [("  if (__syncthreads_and(same)) {",
                      "  if (__syncthreads_and(same) && H < 0) {")]),
    ("no_sobel", [(
        "        mag[r][c] = in_plane ? (int)(uabs(dx) + uabs(dy)) : 0;",
        "        mag[r][c] = in_plane ? (int)l : 0;")]),
    ("no_nms", [(
        "        bool kept = m > na && (dir < 2 ? m >= nb : m > nb);",
        "        bool kept = m > 3;")]),
    ("no_stores", [(
        "      if (r >= 2 && r <= MH - 3 && i < H && j < W)",
        "      if (r >= 2 && r <= MH - 3 && i < H && j < W && mid == 77)")]),
)
SIZES = (256, 512, 1024)


def time_tree(tag):
    """In a child whose cwd is the tree: both passes' device time a call."""
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import boundary
    build.build_all(["canny"])
    out = {"variant": tag}
    for size in SIZES:
        labels = chip_smoke.label_planes(size)
        g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        noise = (torch.rand(labels.shape, generator=g, device="cuda") <
                 0.5).to(torch.int32)
        for kind, planes in (("labels", labels), ("noise", noise)):
            same = torch.equal(boundary.boundary_label(planes),
                               boundary.boundary_label_reference(planes))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    boundary.boundary_label(planes)
                torch.cuda.synchronize()
            dev = {e.key: e.device_time_total / 20 for e in prof.key_averages()
                   if e.device_time_total > 0}
            out[f"{kind}_{size}"] = {
                "pass1_us": sum(v for k, v in dev.items()
                                if "canny_tile_kernel" in k),
                "pass2_us": sum(v for k, v in dev.items()
                                if "canny_kernel" in k),
                "matches_plain": same}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(time_tree(args.child)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    text = open(os.path.join(ROOT, SRC)).read()
    lines = []
    for name, edits in VARIANTS:
        tree = os.path.join(ROOT, "build", "canny_ablate", name)
        shutil.rmtree(tree, ignore_errors=True)
        os.makedirs(tree)
        shutil.copytree(os.path.join(ROOT, "resuneta_torch"),
                        os.path.join(tree, "resuneta_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tree)
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the kernel no longer has {old!r}")
            src = src.replace(old, new)
        with open(os.path.join(tree, SRC), "w") as f:
            f.write(src)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", name], cwd=tree, check=True,
                             capture_output=True, text=True, timeout=600)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join([json.dumps({"card": smi})] + lines) + "\n")


if __name__ == "__main__":
    main()
