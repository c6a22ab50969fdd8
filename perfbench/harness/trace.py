"""Spans, and the device trace of a steady slice of the run.

`Spans` keeps the host time of the benchmark's calls into the program's
layers (`loader.get_batch`, `train.step`, `scene.predict`). In a traced
run they are timed during the measured window (perf_counter, a few
hundred nanoseconds a call), and inside the profiled slice they are
`record_function` ranges instead, so the trace names the host's work by
layer. In an untraced run nothing is recorded.

`capture` profiles a slice under torch.profiler (CPU and CUDA activity),
writes the Chrome trace to TMPDIR, reads it back and deletes it.
`Trace` reduces it: the slice is the `perfbench.slice` range, which
starts and ends on a synchronised device; busy time is the union of the
device's kernels, copies and sets within it (not their sum); an idle gap
is named by the benchmark span and the innermost host operation that
cover its middle.
"""

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

SLICE = "perfbench.slice"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


class Marks:
    """Seconds of the phases of a set-up: mark(name) closes the phase that
    began at the last mark."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def __call__(self, name):
        t = time.perf_counter()
        self.seconds[name] = t - self._t
        self._t = t


class Spans:
    def __init__(self, on):
        self.on = on
        self.profiling = False
        self.names = set()
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        self.names.add(name)
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
            return
        t0 = time.perf_counter()
        yield
        self.times[name].append(time.perf_counter() - t0)


def capture(body, spans):
    """Run body() under the profiler inside the slice range; returns the
    Trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    spans.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU] +
                     ([ProfilerActivity.CUDA] if card else [])) as prof:
            with record_function(SLICE):
                sync()
                body()
                sync()
    finally:
        spans.profiling = False
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"perfbench-trace-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    return Trace(events, spans.names)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """A profiled slice: times in seconds, from the trace's microseconds."""

    def __init__(self, events, span_names):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        sl = [e for e in xs if e.get("name") == SLICE and
              e.get("cat") == "user_annotation"]
        if not sl:
            raise RuntimeError("the trace holds no perfbench.slice range")
        self.t0 = float(sl[0]["ts"])
        self.t1 = self.t0 + float(sl[0]["dur"])
        self.window_s = (self.t1 - self.t0) / 1e6

        def inside(e):
            return float(e["ts"]) < self.t1 and \
                float(e["ts"]) + float(e["dur"]) > self.t0

        self.device = [(e["name"], float(e["ts"]), float(e["dur"]))
                       for e in xs if e.get("cat") in _DEVICE_CATS and
                       inside(e)]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"])
                     for e in xs if e.get("cat") in _HOST_CATS and inside(e)]
        self.spans = [(e["name"], float(e["ts"]), float(e["dur"]))
                      for e in xs if e.get("cat") == "user_annotation" and
                      e["name"] in span_names and inside(e)]
        busy = _union([(max(t, self.t0), min(t + d, self.t1))
                       for _, t, d in self.device])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.gaps = []
        at = self.t0
        for a, b in busy + [[self.t1, self.t1]]:
            if a > at:
                self.gaps.append((at, a))
            at = max(at, b)

    def kernels(self, names):
        """[(name, seconds)] of the device operations whose name contains
        one of `names`."""
        return [(n, d / 1e6) for n, _, d in self.device
                if any(k in n for k in names)]

    def host_seconds(self, names):
        """The summed seconds of host runtime calls named in `names`."""
        return sum(d for n, _, d, _ in self.host if n in names) / 1e6

    def device_ops(self, top=10):
        tot = defaultdict(float)
        for n, _, d in self.device:
            tot[n] += d / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:top]

    def _innermost(self, items, t):
        best = None
        for it in items:
            if it[1] <= t <= it[1] + it[2] and \
                    (best is None or it[2] < best[2]):
                best = it
        return best

    def idle_gaps(self, top=10):
        """The longest idle gaps, each named
        '<benchmark span>:<innermost host operation>' at its middle."""
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) / 2
            span = self._innermost(self.spans, mid)
            op = self._innermost(self.host, mid)
            out.append([f"{span[0] if span else 'no_span'}:"
                        f"{op[0] if op else 'idle_host'}", (b - a) / 1e6])
        return out
