"""engine step: the host's own cost of one call of the engine's step, in
ms: the median host-clock time of ``harness.BURST`` calls made right after
a sync, while the launch queue has room (in the timed window the queue is
full and a call waits for the card)."""
import statistics


def read(ctx):
    return statistics.median(ctx.step_host_s) * 1e3
