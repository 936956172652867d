"""model: the whole train step's share of the card's peak, in %: the train
step's model operations (``counts.train_flops_per_read``: the forward's
matrix products and the backward's two a layer) over every read of the
timed window, over the window's seconds, over the peak of the precision the
step runs in (float32, TF32 off: ``counts.PEAKS``)."""


def read(ctx):
    flops = ctx.counts.peak(ctx.kind, ctx.precision)
    if flops is None:
        return None
    return 100.0 * ctx.counts.train_flops_per_read(ctx.widths) * ctx.window_reads / ctx.window_s / flops
