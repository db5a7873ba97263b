"""The window's requests as a share of the card's peak, %: the least time
their model operations take (the encoder once, the UNet at every reverse
step; f32 products at 165 TFLOP/s, ``benchmark/flops.py``), over the window."""

from benchmark import flops


def read(ctx):
    if ctx.mode != "predict":
        return None
    return 100.0 * flops.least_seconds(ctx.flops) * ctx.units / ctx.window_s
