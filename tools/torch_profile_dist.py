#!/usr/bin/env python3
"""Data-parallel training across the visible cards, one process a card
(NCCL), against one process on the whole batch.

    python3 tools/torch_profile_dist.py [--out FILE]

Builds the kernels, writes `chip_smoke.py`'s train_cli packed set, then
runs `chip_smoke.dist_compare` over NCCL at 2 ranks and at every visible
card (the 256 px x 16 bf16 dense-trunk step, 3 SGD steps, 16 / R rows a
rank, K1-K6 live on each; the rows, the updates and the BN buffers
against one process at `chip_smoke.STEP_TOL`'s limits, the ranks'
parameters bit for bit, each rank's launches), and
`chip_smoke.dist_cli`: `cli.train_isprs --gpu_parallel True` on every
card for one epoch. Needs 2 cards or more. Prints the card (nvidia-smi
name and power limit) and one JSON line a run (rank 0's step times beside
one process's); --out also writes them to FILE.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    n = torch.cuda.device_count()
    if n < 2:
        print(f"torch_profile_dist: {n} card visible; it needs 2 or more",
              file=sys.stderr)
        return 1
    from resuneta_torch.data import write_packed_dataset
    from resuneta_torch.kernels import build

    smi = cs.phase_build(build)
    rng = np.random.default_rng(cs.SEED + 7)
    data = cs.WORK_DIR / "train_cli" / "data"
    write_packed_dataset(
        str(data), rng.integers(0, 256, (cs.CLI_PATCHES, cs.PATCH, cs.PATCH,
                                         3), dtype=np.uint8),
        cs.voronoi_ids(cs.CLI_PATCHES, cs.PATCH, cs.NUM_CLASSES, rng),
        cs.NUM_CLASSES)
    rows = []
    for ranks in sorted({2, n}):
        t0 = time.time()
        res = cs.dist_compare("nccl", cs.DIST_DIR / f"nccl{ranks}",
                              ranks=ranks)
        res.pop("ranks_out")
        rows.append({"run": f"nccl_{ranks}", **res,
                     "seconds": time.time() - t0, "card": smi})
        print(json.dumps(rows[-1]), flush=True)
        if res["failed"]:
            raise RuntimeError(f"{ranks} NCCL ranks: {res['failed']}")
    rows.append({"run": "cli_gpu_parallel", **cs.dist_cli(data, n),
                 "card": smi})
    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
