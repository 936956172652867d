"""op wrappers: host time in the kernel wrappers' input checks, in ms a
step of the timed window: the ``ops.check`` spans' seconds (``check_tensor``,
``check_host_kmer_ids``, the MC wrapper's ``_check_sites``, the k-mer range)
over the window's steps."""
from portbench import spans

start, stop = spans.start, spans.stop


def read(ctx):
    check = spans.seconds(ctx, "ops.check")
    return None if check is None else check / ctx.steps * 1e3
