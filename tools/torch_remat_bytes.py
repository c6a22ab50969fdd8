#!/usr/bin/env python3
"""What the train step's forward keeps for its backward, with and without
remat (resuneta_torch/train/steps.py make_train_step(remat=...)).

    python3 tools/torch_remat_bytes.py [--patch 1024] [--batch 2]
        [--device cuda] [--out f.json]

The forward and loss of one step of the ISPRS multitask d6 (bf16, the
card's default routing, Tanimoto on four heads, make_device_pipeline on
seeded uint8 patches) in each mode, from the same seeded weights, as
make_train_step runs them; then the backward. Read: on a card the device
memory the forward leaves allocated (memory_allocated after the forward
less before it: everything held for the backward) and the step's peak
(max_memory_allocated); on any device, over distinct storages, what
autograd saves outside the checkpointed blocks
(torch.autograd.graph.saved_tensors_hooks: inside a block the
checkpoint's own hooks take over), by dtype, and where the policy's
context shows op outputs (PyTorch 2.13 on), what it keeps inside them, by
op. Prints one JSON object and writes it to --out.
"""

import argparse
import contextlib
import json
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from resuneta_torch import losses  # noqa: E402
from resuneta_torch.data import make_device_pipeline  # noqa: E402
from resuneta_torch.models import ResUnetA  # noqa: E402
from resuneta_torch.models.resuneta import remat as remat_scope  # noqa: E402
from resuneta_torch.train import steps  # noqa: E402

HEADS = ("seg", "bound", "dist", "color")


def one_step(remat, patch, batch, device):
    rng = np.random.default_rng(3)
    raw = {"image_u8": rng.integers(0, 256, (batch, patch, patch, 3),
                                    dtype=np.uint8),
           "label_ids": rng.integers(0, 5, (batch, patch, patch),
                                     dtype=np.uint8),
           "aug": rng.integers(0, 5, batch)}
    model = ResUnetA(5, img_size=patch, dtype=torch.bfloat16, device=device,
                     generator=torch.Generator().manual_seed(0))
    model.train()
    fns = losses.make_losses("tanimoto")
    batch_t = make_device_pipeline(5, 1, device=device)(raw)
    saved, kept = {}, {}

    def policy(ctx, op, *args, **kwargs):
        out = steps.SAVE_CONVS(ctx, op, *args, **kwargs)
        res = getattr(ctx, "op_output", None)
        if out == steps.CheckpointPolicy.MUST_SAVE and res is not None \
                and not ctx.is_recompute:
            for t in (res if isinstance(res, tuple) else (res,)):
                kept[t.untyped_storage().data_ptr()] = (
                    str(op), t.untyped_storage().nbytes())
        return out

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = (
            str(t.dtype).replace("torch.", ""), t.untyped_storage().nbytes())
        return t

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with remat_scope(policy) if remat else contextlib.nullcontext():
            out = model(batch_t["image"])
        total = sum(fns[h](batch_t[h], out[h]) for h in HEADS)
    if cuda:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
    total.backward()
    if cuda:
        torch.cuda.synchronize()
    by_dtype, by_op = defaultdict(int), defaultdict(int)
    for kind, n in saved.values():
        by_dtype[kind] += n
    for kind, n in kept.values():
        by_op[kind] += n
    na = "not measured (CPU)"
    return {"held_after_forward_bytes": held if cuda else na,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else na,
            "saved_outside_blocks_bytes": dict(by_dtype),
            "kept_by_policy_bytes": dict(by_op) if kept or not remat
            else "not visible to this PyTorch's policy context"}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--patch", type=int, default=1024)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out = {"patch": args.patch, "batch": args.batch, "dtype": "bfloat16",
           "device": (torch.cuda.get_device_name(0)
                      if torch.device(args.device).type == "cuda"
                      else args.device)}
    for remat in (False, True):
        out["remat" if remat else "plain"] = one_step(
            remat, args.patch, args.batch, args.device)
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
