"""BENCHMARK.json against the rules it is held to, and every cell,
configuration, mix, limit and metric found by name."""
import json
import os
import re

import pytest

from portbench import check, harness

SPEC = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_keys_and_sizes():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC["paths"]) <= 16 and 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32 and all(1 <= len(w) <= 200 for w in SPEC["command"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and section != "end_to_end" and not (section == "per_layer" and key == "source"):
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_finds_its_files_and_reports_what_it_must():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in configs.values():
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert os.path.exists(os.path.join(harness.HERE, "reference", c["name"] + ".py"))
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)
    for w in SPEC["workloads"]:
        assert os.path.exists(os.path.join(harness.HERE, "traffic", w["traffic"] + ".json"))
        limits = harness.load_json(harness.HERE, "limits", w["name"] + ".json")
        assert set(limits) == set(check.NAMES)
        e2e = [m["name"] for m in harness.cell_metrics(SPEC, "end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in harness.cell_metrics(SPEC, "per_layer", w["name"]):
            assert m["moves"] in e2e, (w["name"], m["name"])
        assert harness.cell_metrics(SPEC, "per_layer", w["name"])


def test_per_layer_metrics_have_readers_and_move_a_reported_metric():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert hasattr(harness.load_reader(m["name"]), "read")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("path", ["configs/m6anet.json", "configs/m6anet_signal.json"])
def test_config_files_hold_the_published_model(path):
    import tomllib

    config = harness.load_json(harness.HERE, path)
    toml = os.path.basename(config["source"])
    assets = os.path.join(harness.ROOT, "m6anet_tpu_torch", "models", "assets", "configs", toml)
    with open(assets, "rb") as f:
        assert config["model"] == tomllib.load(f)
    assert config["reduced"] == []
