"""The numbers of the output check, each compared with its limit in
perfbench/limits/<workload>.json.

Training (the first three steps of the window's own call, against the
reference from the same weights and raw batches):
- loss_rel: the largest |loss - reference| / |reference| of the steps;
- grad_norm_gap: of the first step's gradient, the largest gap between a
  leaf's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
- change_norm_gap: the same of the parameters' change over the steps.
Both leave out the leaves whose first reference gradient is under a
thousandth of the median leaf's: the biases that a BatchNorm follows,
whose gradient is nought but for rounding, so that the program's is its
rounding alone (the stem's bias, summed over 2M pixels in bf16, reads
several median leaves) and Adam moves them by round-off alone.
Whole-tile segmentation:
- logit_gap: over the sampled pixels of the tiles the window finished,
  the widest gap by which the reference's logit of the class the program
  returned lies below the reference's best logit;
- logit_gap_rounding: that gap over the widest gap between the
  reference's logits with bf16 products (the configuration's) and in
  float32: the seeded weights set the logits' scale, which differs from
  seed to seed, and rounding errors scale with it.
"""

import statistics

import torch


def _gap(prog, ref, keys):
    """The worst leaf's gap and the three worst leaves."""
    med = statistics.median(ref[k] for k in keys)
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k)
                   for k in keys), reverse=True)
    return gaps[0][0], [f"{k} {g:.4g}" for g, k in gaps[:3]]


def train_numbers(prog, ref):
    """prog, ref: {"losses": [..], "grad_norms": {leaf: ..},
    "change_norms": {leaf: ..}} -> ({number: value}, {number: its three
    worst leaves})."""
    loss = max(abs(p - r) / abs(r) for p, r in
               zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = [k for k in g if g[k] >= 1e-3 * med]
    grad, grad_leaf = _gap(prog["grad_norms"], g, moved)
    change, change_leaf = _gap(prog["change_norms"], ref["change_norms"],
                               moved)
    return ({"loss_rel": loss, "grad_norm_gap": grad,
             "change_norm_gap": change},
            {"grad_norm_gap": grad_leaf, "change_norm_gap": change_leaf})


def scene_numbers(ref_logits, ids, rounding):
    """ref_logits (N, H, W, C) float, ids (N, H, W) ints, rounding: the
    widest gap between the reference's logits with bf16 products and in
    float32 -> {"logit_gap": the widest gap of the chosen class's logit
    below the best, "logit_gap_rounding": that gap over `rounding`,
    "flip_share": the share of pixels whose class is not the reference's
    best}."""
    ids = torch.as_tensor(ids).to(ref_logits.device).long()
    chosen = ref_logits.gather(-1, ids[..., None])[..., 0]
    best = ref_logits.amax(dim=-1)
    gap = float((best - chosen).max())
    return {"logit_gap": gap, "logit_gap_rounding": gap / rounding,
            "flip_share": float((chosen < best).float().mean())}
