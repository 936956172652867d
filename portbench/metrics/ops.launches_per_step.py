"""op wrappers: the counts the port's kernel wrappers keep, per step of
the timed window: ``fused_infer_kernel.launch_count`` (calls of the fused
entry), ``encoder_kernel.launch_count``, ``site_reduce_launch_count`` (phase
B), ``tc_launch_counts`` (the tensor-core phase A, every precision),
``mc_kernel.launch_count`` and ``long_launch_count``.
``wide_launch_counts`` is left out: its launches are already counted
among the others'."""


def _total(ctx):
    f, m = ctx.program.fused_infer_kernel, ctx.program.mc_kernel
    return (f.launch_count + ctx.program.encoder_kernel.launch_count + f.site_reduce_launch_count
            + sum(f.tc_launch_counts.values()) + m.launch_count + m.long_launch_count)


def start(ctx):
    ctx.state["launches"] = _total(ctx)


def stop(ctx):
    ctx.state["launches"] = _total(ctx) - ctx.state["launches"]


def read(ctx):
    return ctx.state["launches"] / ctx.steps
