"""device: the share of the profiled sub-window in which the card ran no
kernel, copy or fill, in % (``trace.Trace``: busy_s over window_s)."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
