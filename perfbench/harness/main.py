"""One run of one cell: `python3 perfbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>`.

Everything a cell needs is found by name from BENCHMARK.json:
perfbench/configs/<config>.json (the model as it is run),
perfbench/traffic/<traffic>.json (the mix, whose "generator" names the
module under perfbench/generators/ that generates and sends it),
perfbench/metrics/<metric>.py (a per-layer metric's reader) and
perfbench/limits/<workload>.json (the limits of the output check).

A run: set-up (the generator builds the program's objects from the seed and
warms every shape the traffic uses), the measured window, in a traced run
a profiled slice after it, then the output check against the plain
reference once the program's state is freed. It prints one JSON line on
stdout, last, and the numbers of the check beside their limits as the
last lines on stderr.
"""

import importlib.util
import json
import math
import os
import sys
import time
import traceback

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "resuneta_tpu")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """perfbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_seconds():
    """Seconds since this process started, from /proc (the interpreter's
    start-up included)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and metric entries."""

    def __init__(self, name, bench=None):
        self.bench = bench or load_json(ROOT, "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.cfg = load_json(HERE, "configs", f"{self.entry['config']}.json")
        self.traffic = load_json(HERE, "traffic",
                                 f"{self.entry['traffic']}.json")
        path = os.path.join(HERE, "limits", f"{name}.json")
        limits = load_json(path) if os.path.exists(path) else {}
        self.limits = limits.get("compared", {})
        self.not_compared = limits.get("not_compared", {})

    def _listed(self, m):
        return self.name in m["workloads"] if "workloads" in m else None

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self._listed(m) in (True, None)]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.bench["per_layer"]:
            listed = self._listed(m)
            if listed or (listed is None and m["moves"] in e2e):
                out.append(m)
        return out


class Run:
    """What a generator is handed: the cell, the seed, the device, the
    window's length and whether the run is traced."""

    def __init__(self, cell, seed, seconds, trace, device):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.chips = cell.chips


class ReadContext:
    """What a per-layer metric's reader gets: the run (its configuration
    and traffic), the traced run's measured window (`measured`: its rates
    and, as "trace_units", the steps or tiles of the profiled slice), the
    window's spans (`spans.times`: {name: [seconds]}), the profiled
    slice (`trace`, harness.trace.Trace) and the yardstick."""

    def __init__(self, run, measured, spans, trace, yardstick):
        self.run, self.cfg, self.traffic = run, run.cfg, run.traffic
        self.measured, self.spans, self.trace = measured, spans, trace
        self.yardstick = yardstick


def check_numbers(numbers, limits):
    """[(name, value, limit)] of the compared numbers and whether each is
    finite and under its limit; a cell without limits is not correct."""
    rows, ok = [], bool(limits)
    for name, spec in limits.items():
        value = numbers.get(name)
        ok = ok and value is not None and math.isfinite(value) and \
            value <= spec["limit"]
        rows.append((name, value, spec["limit"]))
    return rows, ok


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def execute(cell, seed, seconds, trace, device, job_hook=None):
    """The run without the look for a card; returns the result dict, the
    check's rows and the job. `job_hook(job)`, where given, may break the
    program's timed path under the job after its set-up is built (the
    fault tests do)."""
    import torch

    from harness.trace import Spans, capture

    run = Run(cell, seed, seconds, trace, device)
    job = load_module("generators", cell.traffic["generator"]).Job(run)
    on_card = torch.device(device).type == "cuda"
    before = process_seconds()
    job.setup(hook=job_hook)
    setup_s = process_seconds()
    job.phases = dict(before_setup=before, **job.phases)
    spans = Spans(trace)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    measured = job.window(seconds, spans)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = None
    if trace:
        tr = capture(lambda: job.traced(spans), spans)
        measured["trace_units"] = job.trace_units
    job.release()
    numbers = job.numbers = job.check()
    rows, correct = check_numbers(numbers, cell.limits)
    correct = correct and measured["failed"] == 0

    metrics = {}
    measured["setup_s"] = setup_s
    measured["peak_mem_gib"] = peak / 2 ** 30
    if trace:
        from harness import yardstick
        ctx = ReadContext(run, measured, spans, tr, yardstick)
        for m in cell.per_layer():
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": metrics,
              "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows, job


def _card_line():
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    try:
        result, rows, job = execute(cell, args.seed, args.seconds, args.trace,
                               "cuda")
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad} after the window; the "
              "benchmark runs the port alone", file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed {args.seed} on {_card_line()}",
          file=sys.stderr)
    print(f"set-up phases (s): {json.dumps(job.phases)}", file=sys.stderr)
    for name, leaf in getattr(job, "worst", {}).items():
        print(f"worst leaves of {name}: {leaf}", file=sys.stderr)
    for name, why in cell.not_compared.items():
        print(f"reading {name} {job.numbers.get(name)!r} (not compared: "
              f"{why})", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
