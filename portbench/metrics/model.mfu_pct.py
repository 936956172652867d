"""model: the whole step's share of the card's peak, in %: the model
operations of every real read the timed window scored
(``counts.model_flops_per_read``) over the window's seconds, over the peak
of the precision the cell runs (``counts.PEAKS``)."""


def read(ctx):
    flops = ctx.counts.peak(ctx.kind, ctx.precision)
    if flops is None:
        return None
    return 100.0 * ctx.counts.model_flops_per_read(ctx.widths) * ctx.window_reads / ctx.window_s / flops
