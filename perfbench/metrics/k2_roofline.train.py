"""K2's share of its roofline over the profiled training steps: K2 is the
one-pass backward of a ResBlock segment (C in {32, 64, 128}): dx, the dW
taps, dbias and the BN sums. Its least time for a step's calls (each
segment of the model once, harness/yardstick.py `k2_seconds`) over the
device time of the kernels that compute it, which are found by the names
in k2_roofline.train.json beside this file, in %. Where the launches
counted are not one a call, the path has changed under the names and
nothing is reported."""

import json
import os

with open(os.path.join(os.path.dirname(__file__), "k2_roofline.train.json")) as _f:
    NAMES = json.load(_f)


def read(ctx):
    tr, units = ctx.trace, ctx.measured.get("trace_units")
    if tr is None or not units:
        return None
    y, t = ctx.yardstick, ctx.traffic
    P, B = t["patch"], t["batch"]
    segs = y.segments(ctx.cfg, P)
    eb = 2 if ctx.cfg["dtype"] == "bfloat16" else 4
    launches = sum(1 for n, _ in tr.kernels([NAMES["once_a_call"]]))
    if launches != len(segs) * units:
        return None
    least = sum(y.k2_seconds(B, h, w, c, eb) for c, h, w, _ in segs)
    spent = sum(s for _, s in tr.kernels(NAMES["kernels"])) / units
    return 100.0 * least / spent if spent > 0 else None
