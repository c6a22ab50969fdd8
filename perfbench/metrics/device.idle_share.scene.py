"""The share of the card's time in which no kernel, copy or set ran, over
whole tiles: 1 - (the union of the device's operations a unit in the
profiled slice) / (the wall time a unit in the traced run's measured
window), in %. The profiler's own host cost stretches the slice's wall
time (a 256 px training step ~2x), not its device time, so the wall time
is the window's, where only the benchmark's spans are timed."""


def read(ctx):
    tr, m = ctx.trace, ctx.measured
    if tr is None or not m.get("trace_units") or not m.get("units"):
        return None
    busy = tr.busy_s / m["trace_units"]
    wall = m["window_s"] / m["units"]
    return 100.0 * (1.0 - busy / wall)
