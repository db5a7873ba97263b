"""Share of the traced sub-window of training steps in which no operation
ran on the device (the union of the kernels' and copies' intervals), %."""


def read(ctx):
    if ctx.mode != "train" or ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share
