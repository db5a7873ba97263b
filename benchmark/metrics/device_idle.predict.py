"""Share of the traced sub-window of whole requests in which no operation
ran on the device (the union of the kernels' and copies' intervals), %."""


def read(ctx):
    if ctx.mode != "predict" or ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share
