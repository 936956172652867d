"""Reduce a ``torch.profiler`` session over a steady sub-window to what the
per-layer readers and the result's ``breakdown`` read: the seconds in which
the card ran something (kernels, copies, fills), each device operation's
launches and seconds, and the longest gaps in which the card ran nothing,
named by what the host was doing then."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

OUTSIDE_OPS = "host outside torch ops (Python, numpy, waits)"
TOP = 10


class Trace(NamedTuple):
    window_s: float  # the profiled sub-window, by the host clock, closed by a sync
    busy_s: float  # the union of the device operations' intervals
    ops: Dict[str, Tuple[int, float]]  # device operation -> (launches recorded, seconds)
    gaps: List[Tuple[str, float]]  # the longest idle gaps, longest first

    def per_launch_s(self, kernel: str) -> Optional[float]:
        """Seconds a launch of the device operations whose name holds
        ``kernel``, over the launches the profiler recorded; None if it
        recorded none."""
        n = sum(count for name, (count, _) in self.ops.items() if kernel in name)
        s = sum(sec for name, (_, sec) in self.ops.items() if kernel in name)
        return s / n if n else None

    def breakdown(self) -> Dict[str, List]:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"device_ops": [[name, sec] for name, (_, sec) in top], "idle_gaps": [list(g) for g in self.gaps[:TOP]]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def reduce(events, window_s: float) -> Trace:
    """``events``: the session's ``prof.events()``; times in microseconds."""
    from torch.autograd import DeviceType

    device, host = [], []
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append((start, end))
            ops[e.name][0] += 1
            ops[e.name][1] += (end - start) * 1e-6
        elif e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
    busy = _merge(device)
    longest = sorted(((a, b) for (_, a), (b, _) in zip(busy, busy[1:])), key=lambda g: g[0] - g[1])[:TOP]
    gaps = []
    for a, b in longest:  # named by the innermost host op running at the gap's middle
        mid = 0.5 * (a + b)
        around = [h for h in host if h[0] <= mid <= h[1]]
        gaps.append((max(around)[2] if around else OUTSIDE_OPS, (b - a) * 1e-6))
    return Trace(window_s, sum(b - a for a, b in busy) * 1e-6, {k: (int(v[0]), v[1]) for k, v in ops.items()}, gaps)
