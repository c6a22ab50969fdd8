#!/usr/bin/env python3
"""K3 (the 1x1 conv over concat parts) alone on the card, for one tree or
two in turns on one card.

    python3 tools/torch_profile_k3.py [--root PARENT] [--out FILE]

Times `chip_smoke.K3_CALLS`, the 12 calls of a dense-trunk train step, at
each patch size of the train cells (256 px x 16, 512 px x 8, 1024 px x 2:
the calls' spatial sizes scaled with the patch), forward and backward
apart, beside cuDNN on the materialised concat/upsample (a 1x1 conv and
its `convolution_backward`) and the bound of `chip_smoke.k3_work`; each
call's result is first held against the plain versions
(`chip_smoke.check_close`). Two times each: `ms` by CUDA events around
20 back-to-back calls after 3, as chip_smoke.py times them (a small call
is paced there by the wrapper's host work), and `device_ms`, the sum of
the call's kernel times under torch.profiler (the wrapper's weight casts
included). With --root, the checkout at PARENT and the one holding this
file run in turns, each in its own process (parent, this, this, parent),
so one call compares them on one card. Prints the card (nvidia-smi name and power limit), one JSON line
per run and one of means per tree; --out also writes the last to FILE.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((256, 16), (512, 8), (1024, 2))
KEYS = ("ms_fwd", "ms_bwd", "device_ms_fwd", "device_ms_bwd",
        "library_ms_fwd", "library_ms_bwd", "library_device_ms_fwd",
        "library_device_ms_bwd", "bound_ms_fwd", "bound_ms_bwd")


def run_one(root):
    """Time every call of every size on the checkout at root."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, reps=10):
        """The device time of one call: its kernels' times summed under
        torch.profiler, over reps calls after a warm one."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and
                   "#" not in e.name) / 1e3 / reps

    import chip_smoke
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import densemm

    build.build_all(["densemm"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    design = getattr(densemm, "k3_design", lambda dt: "pr3")(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 8)
    calls = {}
    for patch, N in SIZES:
        f = patch // 256
        rows = []
        for name, parts0, cout in chip_smoke.K3_CALLS:
            parts = tuple((c, h * f, a, k, s) for c, h, a, k, s in parts0)
            s0 = parts[0][4]
            H = parts[0][1] // s0 * parts[0][3]
            xs = [torch.randn((N, h, h, c), generator=g, device="cuda").to(
                torch.bfloat16) for c, h, _, _, _ in parts]
            cin = sum(p[0] for p in parts)
            w = torch.randn((cin, cout), generator=g, device="cuda") / \
                cin ** 0.5
            bias = torch.randn(cout, generator=g, device="cuda") * 0.1
            spec = {"acts": [p[2] for p in parts],
                    "ups": [p[3] for p in parts],
                    "strides": [p[4] for p in parts]}
            gr = torch.randn((N, H, H, cout), generator=g,
                             device="cuda").to(torch.bfloat16)
            y = densemm.dense_mm_fwd(xs, w, bias, **spec)
            got = densemm.dense_mm_bwd(xs, gr, w, **spec)
            chip_smoke.check_close(f"K3 {name} y", y, densemm.dense_mm_reference(
                xs, w, bias, **spec))
            want = densemm.dense_mm_bwd_reference(xs, gr, w, **spec)
            for i, (dx, wdx) in enumerate(zip(got[0], want[0])):
                chip_smoke.check_close(f"K3 {name} dx_{i}", dx, wdx)
            chip_smoke.check_close(f"K3 {name} dW", got[1], want[1])
            chip_smoke.check_close(f"K3 {name} dbias", got[2], want[2])
            del y, got, want
            cat = torch.cat([
                densemm.upsample_nearest(torch.relu(x) if a else x, k)
                for x, (_, _, a, k, _) in zip(xs, parts)], dim=3).permute(
                    0, 3, 1, 2)
            wl = w.t().to(torch.bfloat16)[:, :, None, None].contiguous(
                memory_format=torch.channels_last)
            bl = bias.to(torch.bfloat16)
            gl = gr.permute(0, 3, 1, 2)
            ff, fb, bf, bb = chip_smoke.k3_work(parts, cout, N, H)
            ms = chip_smoke.cuda_ms

            def lib_fwd():
                return F.conv2d(cat, wl, bl, stride=s0)

            def lib_bwd():
                return torch.ops.aten.convolution_backward(
                    gl, cat, wl, [cout], [s0, s0], [0, 0], [1, 1], False,
                    [0, 0], 1, [True, True, True])

            row = {"call": name, "N": N, "H": H,
                   "device_ms_fwd": device_ms(lambda: densemm.dense_mm_fwd(
                       xs, w, bias, **spec)),
                   "device_ms_bwd": device_ms(lambda: densemm.dense_mm_bwd(
                       xs, gr, w, **spec)),
                   "library_device_ms_fwd": device_ms(lib_fwd),
                   "library_device_ms_bwd": device_ms(lib_bwd),
                   "ms_fwd": ms(lambda: densemm.dense_mm_fwd(
                       xs, w, bias, **spec), reps=20, warmup=3),
                   "ms_bwd": ms(lambda: densemm.dense_mm_bwd(
                       xs, gr, w, **spec), reps=20, warmup=3),
                   "library_ms_fwd": ms(lib_fwd, reps=20, warmup=3),
                   "library_ms_bwd": ms(lib_bwd, reps=20, warmup=3),
                   "bound_ms_fwd": chip_smoke.bound(ff, fb)[0],
                   "bound_ms_bwd": chip_smoke.bound(bf, bb)[0]}
            rows.append(row)
            del xs, cat, gl, gr
        calls[str(patch)] = rows
    sums = {p: {k: sum(r[k] for r in rows) for k in KEYS}
            for p, rows in calls.items()}
    return {"root": root, "card": smi, "design": design, "calls": calls,
            "sums": sums}


def mean_runs(runs):
    """The runs of one tree: each number averaged, and the spread of the
    sums (their min and max)."""
    out = {"root": runs[0]["root"], "card": runs[0]["card"],
           "design": runs[0]["design"], "calls": {}, "sums": {},
           "sum_spread": {}}
    for p in runs[0]["calls"]:
        out["calls"][p] = [
            {"call": rs[0]["call"], "N": rs[0]["N"], "H": rs[0]["H"],
             **{k: sum(r[k] for r in rs) / len(rs) for k in KEYS}}
            for rs in zip(*(run["calls"][p] for run in runs))]
        out["sums"][p] = {k: sum(run["sums"][p][k] for run in runs) /
                          len(runs) for k in KEYS}
        out["sum_spread"][p] = {
            k: [min(run["sums"][p][k] for run in runs),
                max(run["sums"][p][k] for run in runs)]
            for k in ("ms_fwd", "ms_bwd")}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="a second checkout (the parent) to time in "
                             "turns with this one")
    parser.add_argument("--out", default=None)
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(os.path.abspath(args.one))), flush=True)
        return
    roots = [HERE]
    if args.root:
        parent = os.path.abspath(args.root)
        roots = [parent, HERE, HERE, parent]
    runs = {}
    for root in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"run on {root} failed:\n{res.stderr[-4000:]}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.setdefault(root, []).append(json.loads(line))
    print(runs[HERE][0]["card"], flush=True)
    out = {("parent" if r != HERE else "this"): mean_runs(rs)
           for r, rs in runs.items()}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
