"""train step: the device operations (kernels, copies, fills) the card ran
a step in the profiled sub-window: every device event the profiler
recorded there over the steps the sub-window called.  None where it
recorded none (no card)."""


def read(ctx):
    launches = sum(count for count, _ in ctx.trace.ops.values())
    return launches / ctx.trace_steps if launches else None
