#!/usr/bin/env python3
"""K2 (the segment's one-pass backward), K9 and K10 alone on the card:
`chip_smoke.py`'s k2 and k10 phases (every K2_SHAPES row held against its
plain version at check_close's limits and timed beside the plain version,
cuDNN's convolution_backward and the bound) and their sums per unit.

    python3 tools/torch_profile_k2.py [--root DIR] [--out FILE]

--root is the checkout whose chip_smoke.py and resuneta_torch are driven
(default: the one holding this file), so one call can time two trees on
one card. Prints the card (nvidia-smi name and power limit), each row as
chip_smoke prints it, then one JSON line of sums: K2 over the 44 calls of
a 16-patch 256 px train step at their shapes, K9 over the 12 calls of a
2-patch 1024 px bwd_wide step, K10 over the 44 segments of a mode-"2"
step; --out also writes that line to FILE.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import torch.nn.functional as F

    import chip_smoke
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import convseg

    smi = chip_smoke.phase_build(build)
    k2 = chip_smoke.phase_k2(convseg)
    k10 = chip_smoke.phase_k10(convseg, F)

    def total(rows):
        return {k: sum(r[k] * r["calls_per_step"] for r in rows)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    out = {"root": root, "card": smi,
           "k2_256px_step": total([r for r in k2 if r["path"] == "train"]),
           "k9_1024px_bwd_wide_step": total(
               [r for r in k2 if r["path"] == "train_wide_1024"]),
           "k10_256px_mode2_step": total(k10),
           "designs": sorted({r.get("design", "pr5") for r in k2})}
    print(json.dumps(out), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
