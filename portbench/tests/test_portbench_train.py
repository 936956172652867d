"""The train cell on the CPU at a small size: the reference's float64 train
steps against the port's ``make_train_step``, a whole run that is
correct, each planted fault and the TF32 control read as not correct, and
a traced run's readers.  The cell's entries wait outside BENCHMARK.json
(``train_step_entries.json``) until the train step can hold a bound; the
tests add them to the spec the harness reads."""
import os

import numpy as np
import pytest
import torch

from portbench import calibrate, check_train, counts, harness, traffic, train_faults
from portbench.reference import train

WORKLOAD = "m6anet.train.step"
SMALL = {"batches": 3, "sites": 32}
CPU = torch.device("cpu")
LIMITS = harness.load_json(harness.HERE, "limits", WORKLOAD + ".json")
ENTRIES = harness.load_json(os.path.dirname(os.path.abspath(__file__)), "train_step_entries.json")
SECTIONS = ("workloads", "end_to_end", "per_layer")


def with_entries(spec):
    return dict(spec, **{section: spec[section] + ENTRIES[section] for section in SECTIONS})


@pytest.fixture(autouse=True)
def spec_with_the_train_cell(monkeypatch):
    spec = with_entries(harness.load_spec())
    monkeypatch.setattr(harness, "load_spec", lambda: spec)


def test_the_train_cells_entries_keep_the_specs_rules():
    spec = harness.load_spec()
    (cell,) = ENTRIES["workloads"]
    names = [e["name"] for section in ("configs",) + SECTIONS for e in spec[section]]
    assert len(names) == len(set(names)) and all(len(n) <= 64 for n in names)
    assert cell["config"] in {c["name"] for c in spec["configs"]} and cell["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(spec["workloads"])
    assert harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json")["kind"] == "train"
    assert set(LIMITS) == set(check_train.NAMES)
    e2e = [m["name"] for m in harness.cell_metrics(spec, "end_to_end", cell["name"])]
    assert sorted(e2e) == ["setup_s", "sites_per_s.train"]
    for m in ENTRIES["per_layer"]:
        assert m["moves"] in e2e and m["workloads"] == [cell["name"]] and hasattr(harness.load_reader(m["name"]), "read")
        assert m["layer"] in {p["layer"] for p in spec["per_layer"] if p not in ENTRIES["per_layer"]} | {"train step"}


def quiet(msg):
    pass


@pytest.mark.parametrize("seed", [5, 2**31 + 17])
def test_reference_train_steps_match_the_port(seed):
    """Three steps of the port from seeded random weights against the
    reference's, by the numbers the cell compares, within its limits.  The
    probability layer's bias is set to -4 (the CLI's
    ``--init_probability_bias``): a fresh init's reads sit near p = 0.5, and
    the noisy-OR of 20 then rounds ``1 - site_p`` to a few float32 ulps, a
    saturation the released weights, the cell's start, do not have."""
    from m6anet_tpu_torch.models.convert import params_to_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.train import loop, losses
    from m6anet_tpu_torch.utils.treeio import flatten_tree

    config = harness.load_json(harness.HERE, "configs", "m6anet.json")
    mix = dict(traffic.load("train.step"), **SMALL)
    model = loop.saturation_aware_init(MILModel(config["model"]).init(torch.Generator().manual_seed(seed % 2**32)))
    weights = flatten_tree(params_to_jax(model.state_dict()))
    optimizer = loop.make_optimizer(model, 4e-4)
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, optimizer)
    batches = [{k: torch.from_numpy(getattr(b, k)) for k in b._fields} for b in traffic.make_train_batches(mix, seed)]
    out = [step(batches[0])]
    params = dict(model.named_parameters())
    first_m = flatten_tree(params_to_jax({n: optimizer.state[p]["exp_avg"] for n, p in params.items()}))
    out += [step(b) for b in batches[1:]]

    ref = check_train.reference_module("m6anet")
    w64 = check_train.tensors(weights, "f64", CPU)
    ref_steps = train.train_steps(ref, train.start_state(ref, w64), batches, 4e-4, 0.0, "f64")
    numbers = check_train.step_numbers([float(loss) for loss, _ in out], [pred for _, pred in out], ref_steps)
    assert max(n["loss_err"] for n in numbers) <= LIMITS["loss_err"]
    assert max(n["pred_err"] for n in numbers) <= LIMITS["pred_err"]
    first_grad = {k: m / (1 - train.BETAS[0]) for k, m in check_train.tensors(first_m, "f64", CPU).items()}
    assert max(check_train.leaf_gaps(first_grad, ref_steps.first_grad, list(first_grad)).values()) <= LIMITS["grad_gap"]
    moved = check_train.moved_leaves(ref, ref_steps.first_grad)
    assert "block3/b" not in moved and "block3/bn_mean" in moved  # BatchNorm cancels the bias before it
    after = check_train.tensors(flatten_tree(params_to_jax(model.state_dict())), "f64", CPU)
    ref_after = dict(ref_steps.state.params, **ref_steps.state.stats)
    gaps = check_train.leaf_gaps(check_train.change(after, w64, moved), check_train.change(ref_after, w64, moved),
                                 moved)
    assert max(gaps.values()) <= LIMITS["change_gap"]


def test_bce_is_torchs_bce_loss():
    p = torch.tensor([0.0, 1e-50, 0.3, 0.9, 1.0], dtype=torch.float64, requires_grad=True)
    y = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0], dtype=torch.float64)
    mask = torch.ones(5, dtype=torch.float64)
    ours = train.bce(p, y, mask)
    (g_ours,) = torch.autograd.grad(ours, p)
    theirs = torch.nn.functional.binary_cross_entropy(p, y)
    (g_theirs,) = torch.autograd.grad(theirs, p)
    assert float(ours.detach()) == pytest.approx(float(theirs.detach()), rel=1e-15)
    assert torch.allclose(g_ours, g_theirs, rtol=1e-12)


def test_adam_is_torchs_adam():
    torch.manual_seed(0)
    theta = torch.randn(7, dtype=torch.float64)
    grads = [torch.randn(7, dtype=torch.float64) * s for s in (1.0, 1e-3, 1e-9)]
    param = torch.nn.Parameter(theta.clone())
    optimizer = torch.optim.Adam([param], lr=4e-4, betas=train.BETAS, eps=train.EPS, weight_decay=1e-2)
    state = train.State({"x": theta}, {}, {"x": torch.zeros(7, dtype=torch.float64)},
                        {"x": torch.zeros(7, dtype=torch.float64)}, 0)
    for g in grads:
        param.grad = g.clone()
        optimizer.step()
        state = train.adam_(state, {"x": g}, 4e-4, 1e-2)
    assert torch.allclose(state.params["x"], param.detach(), rtol=0, atol=1e-15)


def run(wrap_step=None, seed=2**31 + 101, trace=False):
    return harness.run(WORKLOAD, seed, 0.05, trace, "cpu", mix_override=SMALL, wrap_step=wrap_step, log=quiet)


def test_a_sound_train_run_is_correct():
    result = run()
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 3 and result["attempted"] % 3 == 0  # whole passes
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(check_train.NAMES)
    assert set(result["metrics"]) == {"sites_per_s.train", "setup_s"}


@pytest.mark.parametrize("fault", sorted(train_faults.FAULTS))
def test_a_broken_train_step_is_not_correct(fault):
    result = run(train_faults.FAULTS[fault])
    assert not result["correct"] and result["failed"] >= 1


def test_the_train_control_fails_the_limits():
    readings = calibrate.readings(WORKLOAD, [2**31 + 202], True, 0.05, "cpu", mix_override=SMALL, log=quiet)
    worst = readings[2**31 + 202]
    assert any(worst[name] > LIMITS[name] for name in LIMITS)


def test_a_traced_train_run_reports_what_the_cpu_can():
    result = run(trace=True)
    assert result["correct"]
    # on the CPU the profiler records no device operation: the device readers read nothing
    assert set(result["metrics"]) == {"train.host_ms_per_step"}
    assert result["metrics"]["train.host_ms_per_step"]["value"] > 0


def test_the_window_copies_the_state_before_each_step():
    cell = harness.make_cell(WORKLOAD, 9, "cpu", mix_override=SMALL, log=quiet)
    done = cell.window(0.0)
    assert done["steps"] == 3 and done["sites"] == 3 * 32 and done["reads"] == 3 * 32 * 20
    params = dict(cell.model.named_parameters())
    keys = cell.copies[0][0]
    ends = dict(zip(keys, cell.states[-1][0]))
    for name, p in params.items():
        assert torch.equal(ends[("param", name)], p.detach())
        assert torch.equal(ends[("m", name)], cell.optimizer.state[p]["exp_avg"])
    records = [cell._record(buffers) for buffers in cell.states]
    assert [r["step"] for r in records] == [6, 7, 8, 9]  # after the warm-up's two passes
    for before, after in zip(records, records[1:]):
        assert not np.array_equal(before["params"]["block3/w"], after["params"]["block3/w"])
    starts = dict(zip(keys, cell.states[0][0]))
    assert np.array_equal(records[0]["params"]["block3/w"], starts[("param", "blocks.3.linear.weight")].numpy().T)


def test_train_flops_and_the_train_mfu_reader():
    from types import SimpleNamespace

    w = counts.model_widths(harness.load_json(harness.HERE, "configs", "m6anet.json")["model"])
    assert counts.train_flops_per_read(w) == 3 * 14164
    ctx = SimpleNamespace(counts=counts, kind="NVIDIA H100 80GB HBM3", precision="f32", widths=w,
                          window_reads=5120 * 2000, window_s=10.0)
    mfu = harness.load_reader("model.mfu_pct.train").read(ctx)
    assert mfu == pytest.approx(100 * 42492 * 5120 * 2000 / 10.0 / 67e12)
    assert harness.load_reader("model.mfu_pct.train").read(SimpleNamespace(**dict(vars(ctx), kind="cpu"))) is None
    trace = SimpleNamespace(ops={"gemm": (64, 0.01), "copy": (32, 0.001)})
    assert harness.load_reader("train.kernels_per_step").read(SimpleNamespace(trace=trace, trace_steps=16)) == 6.0
    assert harness.load_reader("train.kernels_per_step").read(SimpleNamespace(trace=SimpleNamespace(ops={}),
                                                                              trace_steps=16)) is None


def test_each_pass_step_is_judged_from_the_state_before_it():
    cell = harness.make_cell(WORKLOAD, 12, "cpu", mix_override=SMALL, log=quiet)
    cell.window(0.0)
    numbers = cell.judge()
    assert len(numbers) == check_train.START_STEPS + SMALL["batches"]
    assert all(0 < n["step_change_gap"] <= LIMITS["step_change_gap"] for n in numbers[check_train.START_STEPS:])


@pytest.mark.parametrize("where", ["loss", "pred", "state"])
def test_a_pass_step_changed_after_the_fact_is_not_correct(where):
    """A loss or a site_p of the pass's second step that differs from what
    the step made fails that step alone; a state after it that differs
    from what it made fails it and the step made from that state."""
    cell = harness.make_cell(WORKLOAD, 11, "cpu", mix_override=SMALL, log=quiet)
    cell.window(0.0)
    if where == "loss":
        cell.last_pass["losses"][1] *= 1.0 + 1e-4
    elif where == "pred":
        cell.last_pass["preds"][1] = cell.last_pass["preds"][1] + 1e-3
    else:
        cell.states[2][0][0].mul_(1.0 + 1e-3)  # the state after step 1: a parameter moved on
    numbers = cell.judge()[check_train.START_STEPS:]
    broken = [i for i, n in enumerate(numbers) if any(n[name] > LIMITS[name] for name in LIMITS)]
    assert broken == ([1, 2] if where == "state" else [1])
