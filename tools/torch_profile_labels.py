#!/usr/bin/env python3
"""The EDT kernel (K5/K7), the Canny boundary kernel (K6/K8) and K4 (max
pool -> 1x1 conv) alone on the card, for one tree or two in turns on one
card.

    python3 tools/torch_profile_labels.py [--root PARENT] [--out FILE]

The EDT: one call over a train step's class planes at each patch size
(`chip_smoke.label_planes`: 80 planes of 256^2, 40 of 512^2, 10 of
1024^2), first held bit for bit against the whole-plane plain version;
on a tree whose wrapper has `plan`, also the designs and tiles of
`chip_smoke.EDT_LAYOUTS` it can be forced to (`ms_by_design`). Canny: one `boundary_label` call
over the same planes (K6 at 256^2, K8 at its default tile at 512^2 and
1024^2), first held bit for bit against the whole-plane plain version,
with its launches, by CUDA events and by device time, beside the bound:
8 bytes a pixel against ~50 integer operations a pixel. K4:
`chip_smoke.K4_CALLS`, the PSP's three calls of a
dense-trunk step, at each patch size (256 px x 16, 512 px x 8, 1024 px x
2), forward and backward apart, first held against the plain versions
(`chip_smoke.check_close`, planted ties), beside the library pair
(F.max_pool2d, then a cuDNN 1x1 conv, and their backward). Two times each:
`ms` by CUDA events around back-to-back calls, and `device_ms`, the sum of
the call's kernel times under torch.profiler; `launches` a call; and the
bound: the EDT's 8 bytes a pixel against ~100 integer operations a pass
for each nonzero pixel (a zero pixel is its own seed and weighs no
candidate) at `chip_smoke.PEAK_SCALAR_OPS`, K4's bytes
(x read once and y written once forward, x and g read and dx written
backward) at `chip_smoke.PEAK_BYTES`. With --root, the checkout at PARENT
and the one holding this file run in turns, each in its own process
(parent, this, this, parent), so one call compares them on one card.
Prints the card (nvidia-smi name and power limit), one JSON line per run
and one of means per tree; --out also writes the last to FILE.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((256, 16), (512, 8), (1024, 2))


def run_one(root):
    """Time the EDT and K4 at every size on the checkout at root."""
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
    from resuneta_torch.ops import boundary, distance, poolconv

    build.build_all(["jfa", "poolconv", "canny"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    ms = chip_smoke.cuda_ms
    edt = {}
    for size, _ in SIZES:
        planes = chip_smoke.label_planes(size)
        P, H, W = planes.shape
        want = distance.distance_transform_edt_reference(planes)
        n0 = distance.LAUNCHES
        got = distance.distance_transform_edt(planes)
        torch.cuda.synchronize()
        launches = distance.LAUNCHES - n0
        chip_smoke.same(f"the EDT at {size}^2", got, want)
        passes = len(distance.tiled_steps(H, W))
        nonzero = int(torch.count_nonzero(planes))
        t_ops = nonzero * 100 * passes / chip_smoke.PEAK_SCALAR_OPS
        t_bytes = P * H * W * 8 / chip_smoke.PEAK_BYTES
        row = {"planes": P, "H": H, "W": W, "launches": launches,
               "nonzero_share": nonzero / planes.numel(),
               "ms": ms(lambda: distance.distance_transform_edt(planes),
                        reps=20, warmup=3),
               "device_ms": device_ms(
                   lambda: distance.distance_transform_edt(planes)),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        if hasattr(distance, "plan"):
            row["design"] = distance.plan(H, W)["design"]
            by = {}
            for kw in chip_smoke.EDT_LAYOUTS[size]:
                def fn(kw=kw):
                    return distance.distance_transform_edt(planes, **kw)
                chip_smoke.same(f"the EDT at {size}^2, {kw}", fn(), want)
                by[json.dumps(kw, sort_keys=True)] = ms(fn, reps=10)
            row["ms_by_design"] = by
        edt[str(size)] = row
        del planes, want, got

    canny = {}
    for size, _ in SIZES:
        planes = chip_smoke.label_planes(size)
        P, H, W = planes.shape
        want = boundary.boundary_label_reference(planes)
        n0 = boundary.LAUNCHES + boundary.TILED_LAUNCHES
        got = boundary.boundary_label(planes)
        torch.cuda.synchronize()
        launches = boundary.LAUNCHES + boundary.TILED_LAUNCHES - n0
        chip_smoke.same(f"Canny at {size}^2", got, want)
        t_ops = 50 * planes.numel() / chip_smoke.PEAK_SCALAR_OPS
        t_bytes = P * H * W * 8 / chip_smoke.PEAK_BYTES

        def fn(planes=planes):
            return boundary.boundary_label(planes)

        row = {"planes": P, "H": H, "W": W, "launches": launches,
               "ms": ms(fn, reps=20, warmup=3), "device_ms": device_ms(fn),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        canny[str(size)] = row
        del planes, want, got

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 9)
    k4 = {}
    for patch, N in SIZES:
        rows = []
        for name, C, S0, cout, k in chip_smoke.K4_CALLS:
            S = S0 * patch // 256
            x = torch.randn((N, S, S, C), generator=g, device="cuda")
            x[..., :C // 2] = torch.round(x[..., :C // 2] * 4) / 4
            x = x.to(torch.bfloat16)
            w = torch.randn((C, cout), generator=g, device="cuda") / C ** 0.5
            bias = torch.randn(cout, generator=g, device="cuda") * 0.1
            gr = torch.randn((N, S // k, S // k, cout), generator=g,
                             device="cuda").to(torch.bfloat16)
            n0, n1 = poolconv.LAUNCHES, poolconv.BWD_LAUNCHES
            y = poolconv.pool_conv_fwd(x, w, bias, k=k)
            got = poolconv.pool_conv_bwd(x, gr, w, k=k)
            torch.cuda.synchronize()
            launches = (poolconv.LAUNCHES - n0, poolconv.BWD_LAUNCHES - n1)
            chip_smoke.check_close(f"K4 {name} y", y,
                                   poolconv.pool_conv_reference(x, w, bias,
                                                                k=k))
            want = poolconv.pool_conv_bwd_reference(x, gr, w, k=k)
            for i, lab in enumerate(("dx", "dW", "dbias")):
                chip_smoke.check_close(f"K4 {name} {lab}", got[i], want[i])
            del y, got, want
            xl = x.permute(0, 3, 1, 2)
            pooled, idx = F.max_pool2d(xl, k, return_indices=True)
            wl = w.t().to(torch.bfloat16)[:, :, None, None].contiguous(
                memory_format=torch.channels_last)
            bl = bias.to(torch.bfloat16)
            gl = gr.permute(0, 3, 1, 2)

            def lib_fwd():
                return F.conv2d(F.max_pool2d(xl, k), wl, bl)

            def lib_bwd():
                dp, _, _ = torch.ops.aten.convolution_backward(
                    gl, pooled, wl, [cout], [1, 1], [0, 0], [1, 1], False,
                    [0, 0], 1, [True, True, True])
                torch.ops.aten.max_pool2d_with_indices_backward(
                    dp, xl, [k, k], [k, k], [0, 0], [1, 1], False, idx)

            Mo = N * (S // k) ** 2
            xb = N * S * S * C * 2
            fb = xb + Mo * cout * 2 + C * cout * 2 + cout * 4
            bb = 2 * xb + Mo * cout * 2 + C * cout * 2 + (C + 1) * cout * 4
            def fwd():
                return poolconv.pool_conv_fwd(x, w, bias, k=k)

            def bwd():
                return poolconv.pool_conv_bwd(x, gr, w, k=k)

            rows.append({
                "call": name, "N": N, "H": S, "C": C, "cout": cout, "k": k,
                "launches_fwd": launches[0], "launches_bwd": launches[1],
                "ms_fwd": ms(fwd, reps=20, warmup=3),
                "ms_bwd": ms(bwd, reps=20, warmup=3),
                "device_ms_fwd": device_ms(fwd),
                "device_ms_bwd": device_ms(bwd),
                "library_ms_fwd": ms(lib_fwd, reps=20, warmup=3),
                "library_ms_bwd": ms(lib_bwd, reps=20, warmup=3),
                "bound_ms_fwd": chip_smoke.bound(2 * Mo * C * cout, fb)[0],
                "bound_ms_bwd": chip_smoke.bound(4 * Mo * C * cout, bb)[0]})
            del x, xl, pooled, idx, gl, gr
        k4[str(patch)] = rows
    k4_sums = {p: {key: sum(r[key] for r in rows) for key in K4_KEYS}
               for p, rows in k4.items()}
    return {"root": root, "card": smi, "edt": edt, "canny": canny, "k4": k4,
            "k4_sums": k4_sums}


K4_KEYS = ("ms_fwd", "ms_bwd", "device_ms_fwd", "device_ms_bwd",
           "library_ms_fwd", "library_ms_bwd", "bound_ms_fwd",
           "bound_ms_bwd")
EDT_KEYS = ("ms", "device_ms", "bound_ms")


def mean_runs(runs):
    """The runs of one tree: the EDT's, Canny's and K4's sums averaged, with
    their spread (min and max), and each label kernel's share of its
    bound (of the mean time by events)."""
    out = {"root": runs[0]["root"], "card": runs[0]["card"], "edt": {},
           "canny": {}, "k4_sums": {}}
    for kernel in ("edt", "canny"):
        for p, row in runs[0][kernel].items():
            vals = {k: [run[kernel][p][k] for run in runs] for k in EDT_KEYS}
            mean = {k: sum(v) / len(v) for k, v in vals.items()}
            out[kernel][p] = {**{k: v for k, v in row.items()
                                 if k not in EDT_KEYS + ("ms_by_design",)},
                              **mean,
                              "share_of_bound": mean["bound_ms"] / mean["ms"],
                              "spread": {k: [min(v), max(v)]
                                         for k, v in vals.items()}}
            if "ms_by_design" in row:
                out[kernel][p]["ms_by_design"] = {
                    d: sum(run[kernel][p]["ms_by_design"][d]
                           for run in runs) / len(runs)
                    for d in row["ms_by_design"]}
    for p in runs[0]["k4_sums"]:
        vals = {k: [run["k4_sums"][p][k] for run in runs] for k in K4_KEYS}
        out["k4_sums"][p] = {**{k: sum(v) / len(v) for k, v in vals.items()},
                             "spread": {k: [min(v), max(v)]
                                        for k, v in vals.items()}}
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
