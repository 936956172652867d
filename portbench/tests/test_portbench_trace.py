"""The reduction of a profiler session: busy seconds, idle gaps named by
the host op around them, device operations by name."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import trace


def ev(name, start, end, device):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_busy_gaps_and_ops():
    events = [
        ev("k1", 0, 100, True), ev("k2", 50, 150, True),  # overlap: busy 0-150
        ev("k1", 400, 500, True),  # gap 150-400, the host in "aten::empty" then
        ev("k1", 510, 600, True),  # gap 500-510, no host op
        ev("step", 100, 450, False), ev("aten::empty", 200, 300, False),
    ]
    t = trace.reduce(events, window_s=1e-3)
    assert t.busy_s == pytest.approx(340e-6)
    assert t.ops["k1"] == (3, pytest.approx(290e-6))
    assert t.per_launch_s("k1") == pytest.approx(290e-6 / 3)
    assert t.per_launch_s("k3") is None
    assert t.gaps[0] == ("aten::empty", pytest.approx(250e-6))
    assert t.gaps[1] == (trace.OUTSIDE_OPS, pytest.approx(10e-6))
    top = t.breakdown()
    assert top["device_ops"][0][0] == "k1" and len(top["idle_gaps"]) == 2
