"""engine step: the host's own work in a call of the engine's step, in ms a
step of the timed window, measured inside the program: the ``engine.step``
spans' seconds less the time their ``ops.launch.<entry>`` spans cover (the
calls into the CUDA entry points, where a full launch queue makes the host
wait), over the window's steps.  Logs the share of the window the
``engine.step`` spans cover."""
import sys

from portbench import spans

start, stop = spans.start, spans.stop


def read(ctx):
    step = spans.seconds(ctx, "engine.step")
    if step is None:
        return None
    print(f"engine.step spans: {step:.6f} s of the {ctx.window_s:.6f} s window ({100 * step / ctx.window_s:.2f}%)",
          file=sys.stderr, flush=True)
    return (step - spans.seconds(ctx, "ops.launch.")) / ctx.steps * 1e3
