"""Device kernels launched in the traced sub-window (copies and fills not
counted), per request it ran."""


def read(ctx):
    if ctx.mode != "predict" or ctx.trace is None:
        return None
    return ctx.trace.kernels / ctx.trace.units
