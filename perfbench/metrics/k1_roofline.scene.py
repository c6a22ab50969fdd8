"""K1's share of its roofline over the profiled tiles: K1 is BN apply,
ReLU and the dilated 3x3 conv of one ResBlock segment (C in {32, 64,
128}). Its least time for a tile's calls (every forward of the tile,
the padded last batch included, x each segment of the model,
harness/yardstick.py `k1_seconds`) over the device time of the kernels
that compute it, which are found by the names in k1_roofline.scene.json
beside this file, in %. Where the launches counted are not one a call,
the path has changed under the names and nothing is reported."""

import json
import math
import os

with open(os.path.join(os.path.dirname(__file__), "k1_roofline.scene.json")) as _f:
    NAMES = json.load(_f)


def read(ctx):
    tr, units = ctx.trace, ctx.measured.get("trace_units")
    if tr is None or not units:
        return None
    y, t = ctx.yardstick, ctx.traffic
    P, B = t["patch"], t["batch"]
    forwards = math.ceil((t["tile"] // P) ** 2 / B)
    segs = y.segments(ctx.cfg, P)
    eb = 2 if ctx.cfg["dtype"] == "bfloat16" else 4
    launches = sum(1 for n, _ in tr.kernels([NAMES["once_a_call"]]))
    if launches != forwards * len(segs) * units:
        return None
    least = forwards * sum(y.k1_seconds(B, h, w, c, eb)
                           for c, h, w, _ in segs)
    spent = sum(s for _, s in tr.kernels(NAMES["kernels"])) / units
    return 100.0 * least / spent if spent > 0 else None
