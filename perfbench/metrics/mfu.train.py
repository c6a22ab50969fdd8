"""The whole training step's share of the card's dense bf16 peak: the
model FLOPs of a patch's forward and backward (harness/yardstick.py)
times the traced run's measured patches/s, over 989 TFLOP/s, in %.

bf16 is the fastest arithmetic either configuration's step uses (the f32
configuration's fused segments multiply in bf16 too), so the share is
bounded by 100% whatever the step's mix of precisions."""


def read(ctx):
    rate = ctx.measured.get("train_patches_per_s")
    if not rate:
        return None
    y = ctx.yardstick
    flops = y.train_flops(ctx.cfg, ctx.traffic["patch"]) * rate
    return 100.0 * flops / y.PEAK_FLOPS["bf16"]
