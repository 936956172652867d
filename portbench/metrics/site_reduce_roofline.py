"""kernels: site_reduce_kernel (phase B, the exact site statistics)
against its roofline, in %: the least time for a batch's phase B
(``counts.phase_b``) over the kernel's device time a launch in the
profiled sub-window."""


def read(ctx):
    per_launch = ctx.trace.per_launch_s("site_reduce_kernel")
    bound = ctx.counts.bound_s(ctx.kind, "f32", *ctx.counts.phase_b(ctx.real_reads, ctx.real_sites))
    return None if per_launch is None or bound is None else 100.0 * bound / per_launch
