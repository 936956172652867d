"""The port's span recorder (``m6anet_tpu_torch.utils.profiling``) over a
traced run's timed window, shared by the readers of ``program_span``
metrics: the first reader's ``start`` switches it on, the first ``stop``
collects it into ``ctx.state["spans"]``, and the others reuse that.  A
program without the recorder leaves ``None`` there, and its readers read
nothing."""


def _profiling():
    from m6anet_tpu_torch.utils import profiling

    return profiling


def start(ctx) -> None:
    if "spans" not in ctx.state:
        profiling = _profiling()
        on = hasattr(profiling, "start_recording")
        if on:
            profiling.start_recording()
        ctx.state["spans"] = "recording" if on else None


def stop(ctx) -> None:
    if ctx.state.get("spans") == "recording":
        ctx.state["spans"] = _profiling().stop_recording()


def seconds(ctx, name: str):
    """The recorded seconds of the spans called ``name`` (with a final
    ``.``, of every span under it), or None where the window recorded no
    ``engine.step``."""
    spans = ctx.state.get("spans")
    if not isinstance(spans, dict) or "engine.step" not in spans:
        return None
    return sum(t.seconds for n, t in spans.items() if n == name or (name.endswith(".") and n.startswith(name)))
