"""The window's training steps as a share of the card's peak, %: the least
time their model operations take at the peaks of their types
(``benchmark/flops.py``: bf16 products at 989 TFLOP/s, f32 products at 165),
over the window."""

from benchmark import flops


def read(ctx):
    if ctx.mode != "train":
        return None
    return 100.0 * flops.least_seconds(ctx.flops) * ctx.units / ctx.window_s
