"""The port's host spans (``utils/profiling.py``): the recorder's counts,
seconds and self seconds, the off path, threads, the spans in a
``torch.profiler`` trace beside the ops they cover, and ``run_inference``'s
stage spans and log lines.  The last test needs the card and skips without
one; the file imports neither JAX nor the JAX package, so on the chip
machine it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""
import json
import logging
import os
import re
import threading
import tomllib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.ops import fused_infer_kernel as fik
from m6anet_tpu_torch.utils import profiling
from m6anet_tpu_torch.utils.profiling import SpanTotals, span, start_recording, stop_recording

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
THRESHOLD = PRETRAINED_CONFIGS["HCT116_RNA002"][1]


@pytest.fixture(autouse=True)
def recorder_off():
    stop_recording()
    yield
    stop_recording()


def _model():
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        return load_model(tomllib.load(f), PRETRAINED_CONFIGS["HCT116_RNA002"][0]).eval()


def _batch(seed=3, n=1024, s=64):
    """A pack_sites-shaped batch: sites of 1-30 reads, padding reads and
    sites at the end."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(s, np.int32)
    counts[: s - 8] = rng.integers(1, 31, size=s - 8)
    while counts.sum() > n - 16:
        counts[counts.argmax()] //= 2
    offsets = np.where(counts > 0, np.cumsum(counts) - counts, 0).astype(np.int32)
    features = rng.normal(size=(n, 9)).astype(np.float32)
    kmer_ids = rng.integers(0, 66, size=(n, 3)).astype(np.int8)
    return features, kmer_ids, offsets, counts


def test_nesting_and_self_time_on_a_controlled_clock(monkeypatch):
    ticks = iter([0, 10, 15, 40, 45, 47, 60, 100, 200, 230])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    start_recording()
    with span("outer", 7):  # 0 .. 100
        with span("inner"):  # 10 .. 15
            pass
        with span("middle"):  # 40 .. 60, holding 45 .. 47
            with span("inner"):
                pass
    with span("outer"):  # 200 .. 230
        pass
    got = stop_recording()
    assert all(isinstance(t, SpanTotals) for t in got.values())
    assert {name: (t.count, round(t.seconds * 1e9), round(t.self_seconds * 1e9)) for name, t in got.items()} == {
        "outer": (2, 130, 105), "inner": (2, 7, 7), "middle": (1, 20, 18)}
    assert stop_recording() == {}


def test_off_a_span_is_the_shared_no_op_and_records_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "_clock", lambda: pytest.fail("the off path read the clock"))
    assert span("a") is span("b", 3) is profiling._NO_SPAN
    with span("a"):
        pass
    monkeypatch.undo()
    start_recording()
    got = stop_recording()
    assert got == {}
    with span("a"):  # after stop_recording: off again
        pass
    assert span("a") is profiling._NO_SPAN


def test_a_span_made_before_it_is_entered_keeps_its_name_and_times_from_its_entry(monkeypatch):
    ticks = iter([0, 5, 20, 26, 30, 40])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    start_recording()
    held = span("held")  # made first, entered last
    with span("other"):  # 0 .. 5
        pass
    with held:  # 20 .. 40, holding 26 .. 30
        with span("inner"):
            pass
    got = stop_recording()
    assert {name: (t.count, round(t.seconds * 1e9), round(t.self_seconds * 1e9)) for name, t in got.items()} == {
        "other": (1, 5, 5), "held": (1, 20, 16), "inner": (1, 4, 4)}


def test_another_threads_spans_do_not_nest_under_this_threads():
    start_recording()
    inside = threading.Event()
    with span("main"):
        def work():
            with span("pack"):
                with span("check"):
                    inside.set()

        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive() and inside.is_set()
    got = stop_recording()
    assert got["main"].self_seconds == got["main"].seconds > 0
    assert got["pack"].count == got["check"].count == 1
    assert got["pack"].self_seconds == pytest.approx(got["pack"].seconds - got["check"].seconds, abs=1e-12)


@pytest.mark.parametrize("method", ["exact", "mc"])
def test_torch_step_spans_sit_in_a_profiler_trace_around_their_ops(method):
    step = engine.make_infer_step(_model(), 64, THRESHOLD, 20, method, "torch", n_iterations=64)
    args = [torch.from_numpy(a) for a in _batch()]
    with torch.no_grad():
        step(*args)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(*args)
            start_recording()  # both on: the recorder gets the same spans
            step(*args)
            recorded = stop_recording()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    names = [e.name for e in events if e.name.startswith(("engine.", "model.", "site_ops."))]
    site_p = "site_ops.site_probability_" + method
    expected = {"engine.step", "site_ops.derive_site_ids", "model.per_read_probability", site_p,
                "site_ops.mod_ratio_exact"}
    assert sorted(names) == sorted(list(expected) * 2)
    assert {name: t.count for name, t in recorded.items()} == dict.fromkeys(expected, 1)
    spans = {e.name: e for e in reversed(events) if e.name in expected}  # the first step's
    outer = spans.pop("engine.step").time_range
    for name, e in spans.items():
        r = e.time_range
        assert outer.start <= r.start <= r.end <= outer.end, name
        ops = [o for o in events if o.name.startswith("aten::") and r.start <= o.time_range.start <= r.end]
        assert ops, f"{name} covers no aten op"


def _inference_lines(tmp_path, monkeypatch, **kwargs):
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("m6anet_tpu_torch.inference")
    logger.addHandler(handler)
    try:
        _, _, norm = PRETRAINED_CONFIGS["HCT116_RNA002"]
        dataset = build_dataset(DATA_DIR, norm_path=norm, mode="Inference")
        engine.run_inference(_model(), dataset, str(tmp_path / "out"), THRESHOLD, read_capacity=2048,
                             site_capacity=32, device="cpu", **kwargs)
    finally:
        logger.removeHandler(handler)
    return lines


def test_run_inference_spans_its_stages_and_keeps_its_log_lines(tmp_path, monkeypatch):
    monkeypatch.delenv("M6ANET_TPU_TRACE_DIR", raising=False)
    start_recording()
    lines = _inference_lines(tmp_path, monkeypatch)
    got = stop_recording()
    batches = int(re.search(r"batches dispatched: (\d+)", "\n".join(lines)).group(1))
    assert batches >= 4
    (stages,) = [line for line in lines if line.startswith("inference stages: ")]
    parts = stages[len("inference stages: "):].split(" ")
    assert all(re.fullmatch(r"[a-z+]+=\d+\.\d{6}s/\d+x", p) for p in parts), stages
    counts = {p.split("=")[0]: int(p.split("/")[1][:-1]) for p in parts}
    assert counts == {"featurize+pack": batches + 1, "dispatch": batches, "write": batches}
    (pack,) = [line for line in lines if line.startswith("pack thread: ")]
    assert re.fullmatch(rf"pack thread: pack=\d+\.\d{{6}}s/{batches + 1}x", pack), pack
    (launches,) = [line for line in lines if line.startswith("kernel launches: ")]
    assert set(json.loads(launches[len("kernel launches: "):]).values()) == {0}
    for stage, count in counts.items():
        assert got["engine." + stage].count == count
    assert got["engine.step"].count == batches and got["data.pack"].count == batches + 1
    # the pack thread's spans are its own: the stage that waits for it holds no child span
    assert got["engine.featurize+pack"].self_seconds == got["engine.featurize+pack"].seconds
    assert got["engine.dispatch"].self_seconds < got["engine.dispatch"].seconds


def test_a_traced_run_writes_the_spans_beside_the_ops(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("M6ANET_TPU_TRACE_DIR", str(trace_dir))
    _inference_lines(tmp_path, monkeypatch)
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ids = {}
    for e in events:
        ids.setdefault(e["name"], []).append(e.get("args", {}).get("id"))
    for name in ("engine.featurize+pack", "engine.dispatch", "engine.write", "engine.step"):
        assert sorted(ids[name]) == list(range(len(ids[name]))), name
    assert len(ids["engine.step"]) == len(ids["engine.dispatch"]) >= 4
    assert len(ids["engine.featurize+pack"]) == len(ids["engine.step"]) + 1
    assert any(name.startswith("aten::") for name in ids)


@pytest.mark.cuda
def test_one_mc_step_on_the_card_records_one_span_a_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    features, kmer_ids, offsets, counts = _batch()
    step = engine.make_infer_step(_model().to(device), len(counts), THRESHOLD, 20, "mc", "cuda_fused",
                                  precision="f32x3")
    args = [torch.from_numpy(a).to(device) for a in (features, kmer_ids, offsets, counts)]
    host = dict(host_sites=(offsets, counts), host_kmer_ids=fik.checked_kmer_ids(kmer_ids))
    with torch.no_grad():
        step(*args, **host)
        torch.cuda.synchronize()
        start_recording()
        step(*args, **host)
        got = stop_recording()
    torch.cuda.synchronize()
    launches = {name: t.count for name, t in got.items() if name.startswith("ops.launch.")}
    assert launches == {"ops.launch.read_prob_tc": 1, "ops.launch.site_reduce": 1, "ops.launch.mc_site": 1}
    assert got["engine.step"].count == 1 and got["ops.check"].count >= 1
    assert got["ops.fused_inference_t"].count == got["ops.site_probability_mc"].count == 1
    assert 0 < got["engine.step"].self_seconds < got["engine.step"].seconds
