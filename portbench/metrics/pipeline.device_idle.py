"""pipeline.device_idle: the share of the traced window in which no kernel,
copy or memset ran on the card (the union of the trace's device
intervals), in %."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
