"""The readers of the program's spans (``spans.py``, ``metrics/*`` with
``"source": "program_span"``): their arithmetic on given span totals, one
recording shared by every reader, nothing read from a program without the
recorder, a traced CPU run that reports each of them, and a trace's idle
gap named after a program span."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from m6anet_tpu_torch.utils.profiling import SpanTotals, span, stop_recording
from portbench import harness, spans, trace

SPAN_METRICS = ("engine.host_busy_ms_per_step", "ops.launch_ms_per_step", "ops.check_ms_per_step")


def _ctx(recorded, steps=10):
    return SimpleNamespace(steps=steps, window_s=0.01, state={"spans": recorded})


def test_readers_on_given_span_totals():
    recorded = {
        "engine.step": SpanTotals(10, 4.0e-3, 1.0e-3),
        "ops.fused_inference_t": SpanTotals(10, 2.5e-3, 0.5e-3),
        "ops.check": SpanTotals(30, 0.6e-3, 0.6e-3),
        "ops.launch.read_prob_tc": SpanTotals(10, 1.0e-3, 1.0e-3),
        "ops.launch.site_reduce": SpanTotals(10, 0.2e-3, 0.2e-3),
        "ops.launch.mc_site": SpanTotals(10, 0.3e-3, 0.3e-3),
        "ops.launched_elsewhere": SpanTotals(10, 9.0, 9.0),
    }
    read = {name: harness.load_reader(name).read(_ctx(recorded)) for name in SPAN_METRICS}
    assert read["ops.launch_ms_per_step"] == pytest.approx(0.15)
    assert read["ops.check_ms_per_step"] == pytest.approx(0.06)
    assert read["engine.host_busy_ms_per_step"] == pytest.approx(0.25)
    assert harness.load_reader("ops.check_ms_per_step.mc").read(_ctx(recorded, steps=20)) == pytest.approx(0.03)
    no_checks = {k: v for k, v in recorded.items() if k != "ops.check"}
    assert harness.load_reader("ops.check_ms_per_step").read(_ctx(no_checks)) == 0.0


@pytest.mark.parametrize("recorded", [None, "recording", {}, {"ops.check": SpanTotals(1, 1.0, 1.0)}])
def test_readers_read_nothing_without_recorded_steps(recorded):
    for name in SPAN_METRICS:
        assert harness.load_reader(name).read(_ctx(recorded)) is None


def test_the_readers_share_one_recording():
    stop_recording()
    ctx = SimpleNamespace(state={}, steps=1)
    readers = [harness.load_reader(name + suffix) for name in SPAN_METRICS for suffix in ("", ".mc")]
    for reader in readers:
        reader.start(ctx)
    with span("engine.step"):
        with span("ops.launch.mc_site"):
            pass
    for reader in readers:
        reader.stop(ctx)
    assert set(ctx.state["spans"]) == {"engine.step", "ops.launch.mc_site"}
    assert ctx.state["spans"]["engine.step"].count == 1
    with span("engine.step"):  # recording is off again
        pass
    assert stop_recording() == {}


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "_profiling", lambda: SimpleNamespace())
    ctx = SimpleNamespace(state={}, steps=5, window_s=1.0)
    reader = harness.load_reader("engine.host_busy_ms_per_step")
    reader.start(ctx)
    reader.stop(ctx)
    assert ctx.state["spans"] is None and reader.read(ctx) is None


@pytest.mark.parametrize("workload", ["m6anet.step.exact", "m6anet.step.mc"])
def test_a_traced_cpu_run_reports_every_span_metric(workload):
    result = harness.run(workload, 2**31 + 7, 0.01, True, "cpu", mix_override={"batches": 1, "reads": 8192, "sites": 16},
                         resolved=("cuda_fused", "f32x3"), log=lambda msg: None)
    assert result["correct"]
    suffix = ".mc" if workload.endswith(".mc") else ""
    for name in SPAN_METRICS:
        assert result["metrics"][name + suffix]["unit"] == "ms"
        assert result["metrics"][name + suffix]["value"] >= 0.0
    # on the CPU the wrappers run their plain versions: no launch, but the host's work
    assert result["metrics"]["ops.launch_ms_per_step" + suffix]["value"] == 0.0
    assert result["metrics"]["engine.host_busy_ms_per_step" + suffix]["value"] > 0.0


def _event(name, start, end, device=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_an_idle_gap_is_named_after_the_innermost_program_span():
    events = [
        _event("kernel", 0, 50, True), _event("kernel", 400, 500, True), _event("kernel", 900, 950, True),
        _event("engine.step", 40, 1000), _event("ops.site_probability_mc", 60, 380),
        _event("ops.check", 100, 300),  # holds the first gap's middle, 225
    ]
    gaps = dict(trace.reduce(events, window_s=1e-3).gaps)
    assert gaps == {"ops.check": pytest.approx(350e-6), "engine.step": pytest.approx(400e-6)}
