"""kernels: the torch backend's per-read tail on the card
(``read_prob_kernel`` of ``fused_infer.cu`` built with no k-mer input,
``encoder_kernel.read_prob_tail``) against its roofline, in %: the least
time for a batch's per-read model at f32 (``counts.phase_a`` over the
mix's features with no k-mer id read: the model reads none) over the
kernel's device time a launch in the profiled sub-window."""


def read(ctx):
    per_launch = ctx.trace.per_launch_s("read_prob_kernel")
    ops, nbytes = ctx.counts.phase_a(ctx.widths, ctx.real_reads, ctx.mix["features_per_read"], 0)
    bound = ctx.counts.bound_s(ctx.kind, "f32", ops, nbytes)
    return None if per_launch is None or bound is None else 100.0 * bound / per_launch
