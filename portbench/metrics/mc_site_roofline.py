"""kernels: mc_site_kernel (the MC site probability) against its roofline,
in %: the least time for a batch's MC estimator (``counts.mc``) over the
kernel's device time a launch in the profiled sub-window."""


def read(ctx):
    per_launch = ctx.trace.per_launch_s("mc_site_kernel")
    work = ctx.counts.mc(ctx.real_reads, ctx.real_sites, ctx.n_iters, ctx.n_samples)
    bound = ctx.counts.bound_s(ctx.kind, "f32", *work)
    return None if per_launch is None or bound is None else 100.0 * bound / per_launch
