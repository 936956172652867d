"""op wrappers: host time in the calls into the CUDA entry points, in ms a
step of the timed window: the ``ops.launch.<entry>`` spans' seconds (each
entry's runtime calls, the launch, and any wait for room in a full launch
queue) over the window's steps."""
from portbench import spans

start, stop = spans.start, spans.stop


def read(ctx):
    launch = spans.seconds(ctx, "ops.launch.")
    return None if launch is None else launch / ctx.steps * 1e3
