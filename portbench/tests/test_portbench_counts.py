"""The counts the rooflines and the MFU divide by."""
import json
import os

import pytest

from portbench import counts, harness

H100 = "NVIDIA H100 80GB HBM3"


def widths(config):
    return counts.model_widths(harness.load_json(harness.HERE, "configs", config + ".json")["model"])


def test_model_flops_per_read():
    assert widths("m6anet") == (15, 150, 32)
    assert counts.model_flops_per_read(widths("m6anet")) == 14164
    assert widths("m6anet_signal") == (9, 150, 32)
    assert counts.model_flops_per_read(widths("m6anet_signal")) == 12364


def test_phase_a_bound_is_its_operations_at_f32x3():
    ops, nbytes = counts.phase_a(widths("m6anet"), 994543, 9, 3)
    assert ops == 14164 * 994543 and nbytes == 43 * 994543
    bound = counts.bound_s(H100, "f32x3", ops, nbytes)
    assert bound == pytest.approx(ops / (989e12 / 3))
    assert bound * 1e3 == pytest.approx(0.0427, abs=5e-4)


def test_phase_b_and_mc_bounds():
    assert counts.bound_s(H100, "f32", *counts.phase_b(994543, 16384)) * 1e3 == pytest.approx(0.00127, abs=1e-5)
    mc_ms = counts.bound_s(H100, "f32", *counts.mc(994543, 16384, 1000, 20)) * 1e3
    assert mc_ms == pytest.approx(16384 * 1000 * 21 / 67e12 * 1e3)


def test_an_unknown_card_reads_no_bound():
    assert counts.bound_s("some other card", "f32", 1.0, 1.0) is None


class _Trace:
    def __init__(self, per_launch, busy=0.9, window=1.0):
        self.per_launch, self.busy_s, self.window_s = per_launch, busy, window

    def per_launch_s(self, kernel):
        return self.per_launch.get(kernel)


def _ctx(**kw):
    from types import SimpleNamespace

    mix = harness.load_json(harness.HERE, "traffic", "step.mc.json")
    base = dict(counts=counts, kind=H100, precision="f32x3", widths=widths("m6anet"), mix=mix, real_reads=994543.0,
                real_sites=16384.0, n_iters=1000, n_samples=20, steps=100, window_s=1.0, window_reads=994543 * 100)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_give_a_share_of_the_bound_and_nothing_without_a_reading():
    bound = counts.bound_s(H100, "f32x3", *counts.phase_a(widths("m6anet"), 994543, 9, 3))
    reader = harness.load_reader("read_prob_tc_roofline")
    assert reader.read(_ctx(trace=_Trace({"read_prob_tc_kernel": bound}))) == pytest.approx(100.0)
    assert reader.read(_ctx(trace=_Trace({"read_prob_tc_kernel": 4 * bound}))) == pytest.approx(25.0)
    assert reader.read(_ctx(trace=_Trace({}))) is None
    assert harness.load_reader("mc_site_roofline").read(_ctx(trace=_Trace({}))) is None
    assert harness.load_reader("device.idle_pct").read(_ctx(trace=_Trace({}, busy=0.75))) == pytest.approx(25.0)
    assert harness.load_reader("device.idle_pct").read(_ctx(trace=_Trace({}, busy=0.0))) is None
    mfu = harness.load_reader("model.mfu_pct").read(_ctx())
    assert mfu == pytest.approx(100 * 14164 * 994543 * 100 / (989e12 / 3))
    assert harness.load_reader("model.mfu_pct").read(_ctx(kind="cpu")) is None
