"""Peak memory allocated on the device over the measured window of training
steps (``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(ctx):
    if ctx.mode != "train" or not ctx.peak_window_bytes:
        return None
    return ctx.peak_window_bytes / 2**30
