"""Per-stage host timing.

``StageTimer`` accumulates named host-side stage durations (the reference's
only instrumentation is wall-clock ``compute_time`` fields — SURVEY.md §5).
A device trace hook (``torch.profiler``) is a later item of ROADMAP.md.
"""
from __future__ import annotations

import contextlib
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
