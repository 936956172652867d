"""Per-stage timing + optional device profiling.

``StageTimer`` accumulates named host-side stage durations (the reference's
only instrumentation is wall-clock ``compute_time`` fields — SURVEY.md §5);
``device_trace`` wraps ``torch.profiler`` so a run can write a
TensorBoard-compatible trace with ``M6ANET_TPU_TRACE_DIR=/path`` set.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
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
    """Write a ``torch.profiler`` trace of the body (host, and the card's
    kernels where a card is usable) into ``$M6ANET_TPU_TRACE_DIR`` when it
    is set; do nothing otherwise."""
    trace_dir = os.environ.get("M6ANET_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
