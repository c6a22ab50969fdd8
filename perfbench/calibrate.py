"""The readings that the output check's limits are set from, on the card:
for each seed, one process builds the cell's set-up from the seed, runs
a short window, reads the program's numbers against the reference, then
the reference put in the program's place in each named mode (a lower
precision of reference/precision.py, or the fault "half", half of each
training batch left out).

    python3 perfbench/calibrate.py --workload <name> --seconds 2 \
        --modes fp8 --seeds 1 2 3 [--out calib.jsonl]

Prints a JSON line a seed and mode; the benchmark's own runs do not run
this."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ["USE_FLAX"] = "0"

from harness import main as hm  # noqa: E402
from harness.trace import Spans  # noqa: E402


def readings(cell, seed, seconds, modes, device="cuda"):
    """[{"seed", "mode", numbers...}] of one seed: the program, then each
    mode."""
    import torch

    run = hm.Run(cell, seed, seconds, False, device)
    job = hm.load_module("generators", cell.traffic["generator"]).Job(run)
    job.setup()
    job.window(seconds, Spans(False))
    job.release()
    out = [dict(seed=seed, mode="program", **job.check())]
    for mode in modes:
        out.append(dict(seed=seed, mode=mode, **job.control(mode)))
    if getattr(job, "worst", None):
        out[0]["worst"] = job.worst
    out[0]["phases"] = job.phases
    del job
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--modes", nargs="*", default=["fp8"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = hm.Cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.time()
            for line in readings(cell, seed, args.seconds, args.modes):
                line["workload"], line["s"] = args.workload, time.time() - t0
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
