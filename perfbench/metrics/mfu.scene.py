"""The whole-tile forward's share of the card's dense bf16 peak: the
model FLOPs of a pixel's forward (a patch's forward over its pixels,
harness/yardstick.py) times the traced run's measured pixels/s of the
class maps returned, over 989 TFLOP/s, in %. The padding of a tile's
last batch is work the card does that no user asked for: it is not
counted."""


def read(ctx):
    rate = ctx.measured.get("scene_mpix_per_s")
    if not rate:
        return None
    y = ctx.yardstick
    P = ctx.traffic["patch"]
    per_px = y.forward_flops(ctx.cfg, P) / (P * P)
    return 100.0 * per_px * rate * 1e6 / y.PEAK_FLOPS["bf16"]
