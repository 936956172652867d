"""kernels: read_prob_tc_kernel (phase A on the tensor cores) against its
roofline, in %: the least time for a batch's phase A (``counts.phase_a``
at the cell's precision) over the kernel's device time a launch in the
profiled sub-window."""


def read(ctx):
    per_launch = ctx.trace.per_launch_s("read_prob_tc_kernel")
    ops, nbytes = ctx.counts.phase_a(ctx.widths, ctx.real_reads, ctx.mix["features_per_read"],
                                     ctx.mix["kmer_positions"])
    bound = ctx.counts.bound_s(ctx.kind, ctx.precision, ops, nbytes)
    return None if per_launch is None or bound is None else 100.0 * bound / per_launch
