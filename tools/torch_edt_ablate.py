#!/usr/bin/env python3
"""The EDT kernel's (K5/K7) cluster sizes and fused tails on the card.

    python3 tools/torch_edt_ablate.py [--out FILE]

`ops/distance.plan` takes the whole-plane cluster's blocks from
CLUSTER_SMEM and MAX_CLUSTER, and the steps design "tail" fuses into its
cluster launch from TAIL; the kernels take any of them. Each variant sets
those constants (in this process) and the wrapper's `design`, runs the EDT
on a train step's class planes at each patch size
(`chip_smoke.label_planes`: 80 planes of 256^2, 40 of 512^2, 10 of
1024^2), holds it bit for bit against the default layout, and times it by
CUDA events (`chip_smoke.cuda_ms`). Prints the card (nvidia-smi name and
power limit), then one JSON line a size: per variant its ms, launches a
call and layout; --out also writes the lines to FILE.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per size: (the wrapper's arguments, the constants of ops/distance.py);
# the first is the default
VARIANTS = {
    256: (({}, {}), ({}, {"CLUSTER_SMEM": 128 * 1024}),
          ({"design": "tail"}, {}), ({"design": "tail"}, {"TAIL": 16})),
    512: (({}, {}), ({}, {"TAIL": 1}), ({}, {"TAIL": 8}), ({}, {"TAIL": 16})),
    1024: (({}, {}), ({}, {"TAIL": 1}), ({}, {"TAIL": 8}), ({}, {"TAIL": 16}),
           ({}, {"TAIL": 8, "MAX_CLUSTER": 4})),
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import distance

    build.build_all(["jfa"])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lines = []
    for size, variants in VARIANTS.items():
        planes = chip_smoke.label_planes(size)
        H, W = planes.shape[1:]
        want = distance.distance_transform_edt(planes)
        chip_smoke.same(f"the EDT at {size}^2", want,
                        distance.distance_transform_edt_reference(planes))
        rows = {}
        for kw, consts in variants:
            saved = {k: getattr(distance, k) for k in consts}
            for k, v in consts.items():
                setattr(distance, k, v)
            try:
                lay = distance.plan(H, W, **kw)
                n0 = distance.LAUNCHES
                got = distance.distance_transform_edt(planes, **kw)
                torch.cuda.synchronize()
                launches = distance.LAUNCHES - n0
                name = json.dumps({**kw, **consts}, sort_keys=True)
                chip_smoke.same(f"the EDT at {size}^2, {name}", got, want)
                rows[name] = {
                    "ms": chip_smoke.cuda_ms(
                        lambda: distance.distance_transform_edt(planes, **kw),
                        reps=10),
                    "launches": launches, "design": lay["design"],
                    "cluster": lay["cs"], "band": lay["band"],
                    "fused_steps": lay["steps"][lay["nbanded"]:]}
            finally:
                for k, v in saved.items():
                    setattr(distance, k, v)
        line = json.dumps({"size": size, "planes": planes.shape[0],
                           "variants": rows})
        print(line, flush=True)
        lines.append(line)
        del planes, want
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
