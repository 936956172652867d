"""The count and the reader of ``read_prob_f32_roofline``: the signal-only
model's per-read tail at f32, which reads a read's 9 features and no k-mer
id, and writes its p."""
from types import SimpleNamespace

import pytest

from portbench import counts, harness

H100 = "NVIDIA H100 80GB HBM3"
READS = 994543.0


def _signal_widths():
    return counts.model_widths(harness.load_json(harness.HERE, "configs", "m6anet_signal.json")["model"])


def _ctx(trace):
    mix = harness.load_json(harness.HERE, "traffic", "step.exact.json")
    return SimpleNamespace(counts=counts, kind=H100, precision="f32", widths=_signal_widths(), mix=mix,
                           real_reads=READS, trace=trace)


class _Trace:
    def __init__(self, per_launch):
        self.per_launch = per_launch

    def per_launch_s(self, kernel):
        return self.per_launch.get(kernel)


def test_the_count_at_the_signal_widths_is_12364_flop_and_40_bytes_a_read():
    assert _signal_widths() == (9, 150, 32)
    assert counts.phase_a(_signal_widths(), 1, 9, 0) == (12364, 40)
    ops, nbytes = counts.phase_a(_signal_widths(), READS, 9, 0)
    # bound by the f32 pipe: 12.3 GFLOP over 67 TFLOP/s, ~0.184 ms; the bytes ~0.012 ms
    assert counts.bound_s(H100, "f32", ops, nbytes) == pytest.approx(ops / 67e12)
    assert counts.bound_s(H100, "f32", ops, nbytes) * 1e3 == pytest.approx(0.1835, abs=5e-4)


def test_the_reader_gives_a_share_of_the_bound_and_nothing_without_the_kernel():
    reader = harness.load_reader("read_prob_f32_roofline")
    bound = 12364 * READS / 67e12
    assert reader.read(_ctx(_Trace({"read_prob_kernel": bound}))) == pytest.approx(100.0)
    assert reader.read(_ctx(_Trace({"read_prob_kernel": 2 * bound}))) == pytest.approx(50.0)
    # a torch step on cuBLAS runs no read_prob_kernel: no reading
    assert reader.read(_ctx(_Trace({"sm80_xmma_gemm_f32f32": 1e-3}))) is None
    ctx = _ctx(_Trace({"read_prob_kernel": bound}))
    ctx.kind = "cpu"
    assert reader.read(ctx) is None
