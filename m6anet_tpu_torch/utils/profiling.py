"""Host spans, per-stage timing and device profiling.

``span(name, id=None)`` marks a part of the program on the host: the
engine's step (``engine.step``), each kernel wrapper (``ops.<wrapper>``),
its input checks (``ops.check``) and each call into a CUDA entry point
(``ops.launch.<entry>``), the torch backend's model and site ops
(``model.*``, ``site_ops.*``), and ``run_inference``'s stages
(``engine.<stage>``, ``data.pack`` on the pack thread).  A span costs a
flag test and nothing more unless one of two things is on:

- a ``torch.profiler`` session: the span enters a host annotation of its
  name, so the trace holds it beside the card's kernels and copies on the
  profiler's clock (``id``, a step's or a batch's number, is the
  annotation's argument where the session records inputs);
- the recorder (:func:`start_recording` / :func:`stop_recording`): the
  count, the seconds and the self seconds of each span name, from
  ``time.perf_counter_ns``, nested per thread.

``StageTimer`` accumulates named host-side stage durations (the reference's
only instrumentation is wall-clock ``compute_time`` fields — SURVEY.md §5)
and opens a span for each (``run_inference`` keeps one for its main
thread's stages, one for the pack thread's ``data.pack``); ``device_trace`` wraps ``torch.profiler`` so a
run can write a TensorBoard-compatible trace with
``M6ANET_TPU_TRACE_DIR=/path`` set.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast  # a host annotation at a tenth of record_function's cost
from torch.autograd import profiler as _torch_profiler  # its _is_profiler_enabled: a session is on

_clock = time.perf_counter_ns


class SpanTotals(NamedTuple):
    count: int
    seconds: float
    self_seconds: float  # seconds less the time the span's child spans cover


class _Recorder:
    """One recording: the spans of each thread that opened one while it
    was on."""

    def __init__(self):
        self.lock = threading.Lock()
        self.threads: list = []

    def thread_spans(self) -> "_ThreadSpans":
        spans = _ThreadSpans(self)
        with self.lock:
            self.threads.append(spans)
        _local.spans = spans
        return spans


class _ThreadSpans:
    """One thread's part of a recording: ``totals`` each name's [count, ns,
    self ns]; ``covered`` the ns its closed spans cover, those nested in
    another counted once (a span's children cover what it grew by while it
    was open)."""

    __slots__ = ("recorder", "covered", "totals")

    def __init__(self, recorder: _Recorder):
        self.recorder, self.covered, self.totals = recorder, 0, {}


_recorder: Optional[_Recorder] = None
_local = threading.local()  # .spans: the thread's _ThreadSpans of the newest recording


def _annotation(name: str, id: Optional[int]) -> _RecordFunctionFast:
    return _RecordFunctionFast(name, (), {} if id is None else {"id": id})


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """A span while the recorder is on, with the profiler's annotation
    where a session is on too."""

    __slots__ = ("name", "spans", "annotation", "mark", "start")

    def __init__(self, name: str, spans: _ThreadSpans, annotation: Optional[_RecordFunctionFast]):
        self.name, self.spans, self.annotation = name, spans, annotation

    def __enter__(self):
        if self.annotation is not None:
            self.annotation.__enter__()
        self.mark = self.spans.covered
        self.start = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = _clock() - self.start
        spans = self.spans
        own = elapsed - (spans.covered - self.mark)
        spans.covered = self.mark + elapsed
        t = spans.totals.get(self.name)
        if t is None:
            spans.totals[self.name] = [1, elapsed, own]
        else:
            t[0] += 1
            t[1] += elapsed
            t[2] += own
        if self.annotation is not None:
            self.annotation.__exit__(exc_type, exc, tb)
        return False


def span(name: str, id: Optional[int] = None):
    """A context manager marking ``name`` on the host (the module
    docstring); with neither the recorder nor a profiler session on, the
    one shared no-op context."""
    recorder = _recorder
    if recorder is None:
        return _annotation(name, id) if _torch_profiler._is_profiler_enabled else _NO_SPAN
    spans = getattr(_local, "spans", None)
    if spans is None or spans.recorder is not recorder:
        spans = recorder.thread_spans()
    return _Span(name, spans, _annotation(name, id) if _torch_profiler._is_profiler_enabled else None)


def start_recording() -> None:
    """Reset the recorder and switch it on."""
    global _recorder
    _recorder = _Recorder()


def stop_recording() -> Dict[str, SpanTotals]:
    """Switch the recorder off; return, by span name, the spans closed
    while it was on, summed over threads (a span opened before
    :func:`start_recording` is not recorded)."""
    global _recorder
    recorder, _recorder = _recorder, None
    merged: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
    if recorder is not None:
        with recorder.lock:
            threads = list(recorder.threads)
        for spans in threads:
            for name, t in list(spans.totals.items()):
                merged[name] = [a + b for a, b in zip(merged[name], t)]
    return {name: SpanTotals(c, ns * 1e-9, own * 1e-9) for name, (c, ns, own) in merged.items()}


class StageTimer:
    def __init__(self, span_prefix: str = "engine."):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.span_prefix = span_prefix

    @contextlib.contextmanager
    def stage(self, name: str, id: Optional[int] = None) -> Iterator[None]:
        """Time the body as stage ``name``, inside the span
        ``<span_prefix><name>`` (``id``: the batch's number)."""
        start = time.perf_counter()
        try:
            with span(self.span_prefix + name, id):
                yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> str:
        parts = [
            f"{name}={self.totals[name]:.6f}s/{self.counts[name]}x"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return " ".join(parts)


@contextlib.contextmanager
def device_trace() -> Iterator[None]:
    """Write a ``torch.profiler`` trace of the body into
    ``$M6ANET_TPU_TRACE_DIR`` when it is set; do nothing otherwise.  The
    trace holds this thread's host ops and spans, with their inputs and ids,
    and the card's kernels and copies where a card is usable.  Another
    thread's spans (the pack thread's ``data.pack``) reach the recorder and
    their ``StageTimer`` but not the trace: torch records other threads only
    in a mode that drops the ids."""
    trace_dir = os.environ.get("M6ANET_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
