#!/usr/bin/env python3
"""K1 (the fused BN -> ReLU -> dilated 3x3 conv forward) alone on the card:
`chip_smoke.py`'s k1 phase (every shape held against the plain version at
K1_RTOL / K1_ATOL and timed beside the plain version, one cuDNN conv of a
precomputed z and the bound) and its sums per unit.

    python3 tools/torch_profile_k1.py [--root DIR] [--out FILE]

--root is the checkout whose chip_smoke.py and resuneta_torch are driven
(default: the one holding this file), so one call can time two trees on
one card. Prints the card (nvidia-smi name and power limit), each row as
chip_smoke prints it, then one JSON line of sums: K1 over the 44 launches
of a 32-patch 256 px forward at their shapes, beside cuDNN's and the
bound, and the same for each level (C) and for the wide tier's shapes,
and the wide eval tier's C = 512 launch (RB(512) at 16^2, batch 32) with
its design; --out also writes that line to FILE. For two trees in turns,
run it as parent, this, this, parent (one process each).
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
    rows = chip_smoke.phase_k1(convseg, F)

    def total(rs, key):
        return {k: sum(r[k] * r[key] for r in rs)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    fwd = [r for r in rows if r["on_path"]]
    out = {"root": root, "card": smi,
           "k1_32patch_forward": total(fwd, "launches_per_forward"),
           "by_level": {r0["C"]: total([r for r in fwd if r["C"] == r0["C"]],
                                       "launches_per_forward")
                        for r0 in fwd},
           "wide_by_path": {p: total([r for r in rows if r["path"] == p],
                                     "launches_per_unit")
                            for p in sorted({r["path"] for r in rows
                                             if not r["on_path"]})},
           "c512_launch": [{k: r.get(k) for k in (
               "N", "H", "d", "design", "ms", "plain_ms", "library_ms",
               "bound_ms", "max_abs_err")} for r in rows if r["C"] == 512],
           "designs": sorted({r.get("design", "pr1") for r in rows})}
    print(json.dumps(out), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
