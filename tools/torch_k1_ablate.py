#!/usr/bin/env python3
"""What paces K1's TMA kernel: each ablation takes one part of the work
out of a copy of convseg.cu and times K1 at the 11 shapes of the 256 px
forward (chip_smoke.K1_LEVELS, batch 32, bf16) beside the kernel as it is.
An ablated kernel's result is wrong; only its time counts.

    python3 tools/torch_k1_ablate.py [--c512] [--out FILE]

Ablations: no_transform (z is not formed: the wgmma reads whatever the z
buffers hold), no_stores (the epilogue computes y but stores none of it),
no_wgmma (no product is issued); and two right variants, ring_3 and
ring_4 (three and four stages instead of two; where the halo plan then
no longer fits shared memory, as at C = 64 with four stages and d = 31, a
K step takes one tap). Each
variant's y is held against the plain version (matches_plain: True for
the kernel as it is and the ring variants). Each copy of the package goes under
build/k1_ablate/<name>/ (git-ignored) and builds there. Prints the card,
then one JSON line a variant: ms per (C, d) and the sum over the 44
launches of a 32-patch forward; --out also writes the lines to FILE.

--c512 takes the C = 512 instance instead (RB(512) of the fwd_wide
forward: 16^2, batch 32, d = 1, bf16 and f32 x): as_is; ring_2 and
ring_3 (two or three stages instead of four); quarters (work items of
128 pixels x one 128-channel quarter of N, each forming its own z, as
before the two warpgroups shared one; three stages in f32, which fit);
no_transform, no_wgmma (as above, at C = 512 only) and no_loads (no
TMA load of x or w at C = 512: the ring's barriers complete on arrival).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("resuneta_torch", "kernels", "csrc", "convseg.cu")
# (name, [(text of convseg.cu, its replacement)]): each text occurs once
ABLATIONS = (
    ("as_is", []),
    ("no_transform", [(
        "for (int p0 = tid / S::CPR; p0 < box_pix; p0 += U * PASS) {",
        "for (int p0 = tid / S::CPR; p0 < 0; p0 += U * PASS) {")]),
    ("no_stores", [(
        "          Io<T>::store2(dst + c,",
        "          if (acc[0] == 12345.0f) Io<T>::store2(dst + c,")]),
    ("no_wgmma", [(
        "          sm90::wgmma<S::NT, 0, 1>(acc, da, db);",
        "          if (da == 1) sm90::wgmma<S::NT, 0, 1>(acc, da, db);")]),
    ("ring_3", [("  static constexpr int STAGES = 2;",
                 "  static constexpr int STAGES = 3;")]),
    ("ring_4", [("  static constexpr int STAGES = 2;",
                 "  static constexpr int STAGES = 4;")]),
)
DEPTH = "  return C < 512 ? FwdShape<C>::STAGES : 4;"
ABLATIONS_512 = (
    ("as_is", []),
    ("ring_2", [(DEPTH, DEPTH.replace(": 4;", ": 2;"))]),
    ("ring_3", [(DEPTH, DEPTH.replace(": 4;", ": 3;"))]),
    ("quarters", [("  static constexpr bool SPLIT_N = C == 512;",
                   "  static constexpr bool SPLIT_N = false;"),
                  (DEPTH, DEPTH.replace(": 4;", ": (sizeof(T) == 2 ? 4 : 3);"))]),
    ("no_transform", [(
        "for (int p0 = tid / S::CPR; p0 < box_pix; p0 += U * PASS) {",
        "for (int p0 = tid / S::CPR; p0 < (C == 512 ? 0 : box_pix); "
        "p0 += U * PASS) {")]),
    ("no_wgmma", [(
        "          sm90::wgmma<S::NT, 0, 1>(acc, da, db);",
        "          if (C != 512 || da == 1) sm90::wgmma<S::NT, 0, 1>(acc, da, "
        "db);")]),
    ("no_loads", [
        ("  const uint32_t stage_tx = box_pix * S::CB * (int)sizeof(T) + "
         "STAGE_W;",
         "  const uint32_t stage_tx = C == 512 ? 0 : box_pix * S::CB * "
         "(int)sizeof(T) + STAGE_W;"),
        ("          sm90::tma_load_4d(st, &map_x, &full[s], kc * S::CB, col, "
         "h0 + (ky - 1) * d, n);",
         "          if (C != 512) sm90::tma_load_4d(st, &map_x, &full[s], "
         "kc * S::CB, col, h0 + (ky - 1) * d, n);"),
        ("          if (!S::W_RESIDENT)", "          if (!S::W_RESIDENT && C != 512)")]),
)


def time_512(tag):
    """In a child whose cwd is the tree: K1 at C = 512, 16^2 x 32, d = 1,
    in bf16 and f32, timed (three timings of 50 launches each)."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import convseg
    build.build_all(["convseg"])
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    C, S, d = 512, 16, 1
    out = {"variant": tag}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((chip_smoke.BATCH, S, S, C), generator=g,
                        device="cuda").to(dt)
        a = torch.rand(C, generator=g, device="cuda") + 0.5
        b = torch.randn(C, generator=g, device="cuda") * 0.2
        w = torch.randn((3, 3, C, C), generator=g, device="cuda") / \
            (3.0 * C ** 0.5)
        bias = torch.randn(C, generator=g, device="cuda") * 0.1
        got = convseg.bn_act_conv(x, a, b, w, bias, dilation=d)
        want = convseg.bn_act_conv_reference(x, a, b, w, bias, dilation=d)
        err = (got.float() - want.float()).abs()
        ok = bool(torch.all(err <= chip_smoke.K1_ATOL +
                            chip_smoke.K1_RTOL * want.float().abs()))
        name = str(dt).split(".")[-1]
        out[name] = {"ms": [chip_smoke.cuda_ms(lambda: convseg.bn_act_conv(
            x, a, b, w, bias, dilation=d), reps=50, warmup=5)
            for _ in range(3)], "matches_plain": ok}
    return out


def time_tree(tag):
    """In a child whose cwd is the tree: K1 at the 11 shapes, timed."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from resuneta_torch.kernels import build
    from resuneta_torch.ops import convseg
    build.build_all(["convseg"])
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    ms, total, ok = {}, 0.0, True
    for C, S, ds in chip_smoke.K1_LEVELS:
        for d in ds:
            x = torch.randn((chip_smoke.BATCH, S, S, C), generator=g,
                            device="cuda").to(torch.bfloat16)
            a = torch.rand(C, generator=g, device="cuda") + 0.5
            b = torch.randn(C, generator=g, device="cuda") * 0.2
            w = torch.randn((3, 3, C, C), generator=g, device="cuda") / \
                (3.0 * C ** 0.5)
            bias = torch.randn(C, generator=g, device="cuda") * 0.1
            got = convseg.bn_act_conv(x, a, b, w, bias, dilation=d)
            want = convseg.bn_act_conv_reference(x, a, b, w, bias,
                                                 dilation=d)
            err = (got.float() - want.float()).abs()
            ok &= bool(torch.all(err <= chip_smoke.K1_ATOL +
                                 chip_smoke.K1_RTOL * want.float().abs()))
            del got, want, err
            t = chip_smoke.cuda_ms(lambda: convseg.bn_act_conv(
                x, a, b, w, bias, dilation=d), reps=20)
            ms[f"C={C} d={d}"] = t
            total += 4 * t       # 4 launches a dilation in a forward
    return {"variant": tag, "ms_44_launches": total, "ms": ms,
            "matches_plain": ok}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--c512", action="store_true")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        timer = time_512 if args.c512 else time_tree
        print(json.dumps(timer(args.child)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    text = open(os.path.join(ROOT, SRC)).read()
    lines = []
    for name, edits in ABLATIONS_512 if args.c512 else ABLATIONS:
        tree = os.path.join(ROOT, "build", "k1_ablate", name)
        shutil.rmtree(tree, ignore_errors=True)
        os.makedirs(tree)
        shutil.copytree(os.path.join(ROOT, "resuneta_torch"),
                        os.path.join(tree, "resuneta_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tree)
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the kernel no longer has {old!r}")
            src = src.replace(old, new)
        with open(os.path.join(tree, SRC), "w") as f:
            f.write(src)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", name] + ["--c512"] * args.c512,
                             cwd=tree, check=True,
                             capture_output=True, text=True, timeout=600)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join([json.dumps({"card": smi})] + lines) + "\n")


if __name__ == "__main__":
    main()
