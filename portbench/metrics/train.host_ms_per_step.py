"""train step: the host's own cost of one call of the train step, in ms:
the median host-clock time of ``harness.BURST`` calls made right after a
sync (the train step makes no host sync, so a call returns once its
launches are queued)."""
import statistics


def read(ctx):
    return statistics.median(ctx.step_host_s) * 1e3
