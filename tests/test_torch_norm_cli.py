"""The port's command line beyond inference and train, held against the JAX
package: ``compute_norm_factors`` (and ``data/norm.py``'s readers and
writer), ``convert``, the five subcommands, the deprecated shims and
``utils/profiling.device_trace``.  Also the two repaired faults of
multi-card runs: ``--distributed`` with a rank late by more than the
process group's timeout merges (the status words go through the job's
store), and a run outside a launcher's job that sees several cards says it
uses one.
"""
import filecmp
import logging
import os
import signal
import socket
import subprocess
import sys
import warnings
from types import SimpleNamespace

import jax  # noqa: F401  (jax before torch, see conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch

from m6anet_tpu.data import norm as jax_norm
from m6anet_tpu.scripts import compute_norm_factors as jax_compute_norm_factors
from m6anet_tpu.scripts import convert as jax_convert
from m6anet_tpu_torch.data import norm
from m6anet_tpu_torch.scripts import compute_norm_factors, convert

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_distributed_worker.py")
SUBCOMMANDS = ["dataprep", "inference", "train", "compute_norm_factors", "convert"]


def test_compute_norm_factors_matches_jax(tmp_path):
    """The .npz files hold the same kmers and values, and each .joblib
    loads to the same dict in either package."""
    args = dict(input_dir=DATA_DIR, n_processes=1)
    compute_norm_factors.main(SimpleNamespace(out_dir=str(tmp_path / "port"), **args))
    jax_compute_norm_factors.main(SimpleNamespace(out_dir=str(tmp_path / "jax"), **args))
    npz = "norm_dict_nanopolish.npz"
    with np.load(tmp_path / "port" / npz) as got, np.load(tmp_path / "jax" / npz) as want:
        assert sorted(got.files) == sorted(want.files) == ["kmers", "mean", "std"]
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
    want = jax_norm.load_norm_factors(str(tmp_path / "jax" / npz))
    assert len(want) >= 5
    for path in (tmp_path / "port" / npz, tmp_path / "port" / "norm_dict_nanopolish.joblib"):
        for load in (norm.load_norm_factors, jax_norm.load_norm_factors):
            got = load(str(path))
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k][0], want[k][0])
                np.testing.assert_array_equal(got[k][1], want[k][1])


@pytest.mark.parametrize("suffix", [".npz", ".joblib", ".bin"])
def test_saved_norm_factors_load_in_either_package(suffix, tmp_path):
    rng = np.random.default_rng(0)
    factors = {k: (rng.normal(size=3), rng.uniform(0.5, 2, size=3)) for k in ("AAACA", "GGACT", "TGACC")}
    path = str(tmp_path / f"norm{suffix}")
    norm.save_norm_factors(factors, path)
    assert os.listdir(tmp_path) == [f"norm{suffix}"]  # no extension appended
    for load in (norm.load_norm_factors, jax_norm.load_norm_factors):
        got = load(path)
        assert sorted(got) == sorted(factors)
        for k in factors:
            np.testing.assert_array_equal(got[k][0], factors[k][0])
            np.testing.assert_array_equal(got[k][1], factors[k][1])


def test_site_readers_match_jax():
    info = pd.read_csv(os.path.join(DATA_DIR, "data.info"))
    json_path = os.path.join(DATA_DIR, "data.json")
    for row in info.iloc[::25].itertuples():
        site = (json_path, row.transcript_id, row.transcript_position, row.start, row.end)
        assert norm.read_kmer(*site) == jax_norm.read_kmer(*site)
        np.testing.assert_array_equal(norm.read_features(*site), jax_norm.read_features(*site))


def test_convert_matches_jax(tmp_path):
    old = tmp_path / "old"
    old.mkdir()
    pd.DataFrame({"transcript_id": ["tx1", "tx2", "tx3"], "transcript_position": [10, 20, 5],
                  "start": [0, 100, 250], "end": [100, 250, 300]}).to_csv(old / "data.index", index=False)
    pd.DataFrame({"transcript_id": ["tx2", "tx1", "tx3"], "transcript_position": [20, 10, 6],
                  "n_reads": [44, 30, 7]}).to_csv(old / "data.readcount", index=False)
    convert.main(SimpleNamespace(input_dir=str(old), out_dir=str(tmp_path / "port")))
    jax_convert.main(SimpleNamespace(input_dir=str(old), out_dir=str(tmp_path / "jax")))
    assert filecmp.cmp(tmp_path / "port" / "data.info", tmp_path / "jax" / "data.info", shallow=False)
    assert len(pd.read_csv(tmp_path / "port" / "data.info")) == 2


def test_help_lists_the_five_subcommands_in_order():
    proc = subprocess.run([sys.executable, "-m", "m6anet_tpu_torch", "--help"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "{" + ",".join(SUBCOMMANDS) + "}" in proc.stdout


@pytest.mark.parametrize("subcommand", SUBCOMMANDS)
def test_each_subcommand_has_help(subcommand, capsys):
    from m6anet_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main([subcommand, "--help"])
    assert exc.value.code == 0
    assert "usage: m6anet_tpu_torch " + subcommand in capsys.readouterr().out


@pytest.mark.parametrize("shim,subcommand", [
    ("dataprep", "dataprep"), ("inference", "inference"), ("train", "train"),
    ("compute_norm_factors", "compute_norm_factors"),
])
def test_deprecated_shims_warn_then_run(shim, subcommand, monkeypatch):
    import importlib

    module = importlib.import_module(f"m6anet_tpu_torch.deprecated.{shim}")
    script = importlib.import_module(f"m6anet_tpu_torch.scripts.{subcommand}")
    ran = []
    monkeypatch.setattr(script, "main", ran.append)
    args = SimpleNamespace()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        module.main(args)
    assert ran == [args]
    (warning,) = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert f"`m6anet_tpu_torch {subcommand}`" in str(warning.message)


@pytest.mark.parametrize("traced", [True, False])
def test_device_trace_writes_only_when_asked(traced, tmp_path, monkeypatch):
    from m6anet_tpu_torch.utils.profiling import device_trace

    trace_dir = tmp_path / "trace"
    if traced:
        monkeypatch.setenv("M6ANET_TPU_TRACE_DIR", str(trace_dir))
    else:
        monkeypatch.delenv("M6ANET_TPU_TRACE_DIR", raising=False)
    with device_trace():
        torch.ones(64).cumsum(0)
    if traced:
        (name,) = os.listdir(trace_dir)
        assert name.endswith(".pt.trace.json") and os.path.getsize(trace_dir / name) > 0
    else:
        assert not trace_dir.exists() and not os.listdir(tmp_path)


# ---------------------------------------------------------------- multi-card

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_a_rank_later_than_the_group_timeout_still_merges(tmp_path):
    """Two gloo ranks of ``inference --distributed`` whose process group
    gives up after 5 s, rank 1 starting its scoring 15 s late: rank 0 waits
    on the job's store, not in a collective, and merges the one-process
    bytes."""
    base = ["inference", "--input_dir", DATA_DIR, "--device", "cpu"]
    from m6anet_tpu_torch.cli import main

    main([*base, "--out_dir", str(tmp_path / "one")])
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        argv = [sys.executable, WORKER, "late", "5", "1", "15", *base, "--out_dir", str(tmp_path / "two"),
                "--distributed"]
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, start_new_session=True))
    errs = []
    for proc in procs:
        try:
            errs.append(proc.communicate(timeout=240)[1])
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
            pytest.fail("a rank outlasted 240 s")
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-3000:]
    assert "rank 1 starts scoring 15 s late" in errs[1]
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert filecmp.cmp(tmp_path / "two" / name, tmp_path / "one" / name, shallow=False), name


@pytest.fixture
def log_lines():
    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Handler()
    logger = logging.getLogger("m6anet_tpu_torch")
    logger.addHandler(handler)
    yield lines
    logger.removeHandler(handler)


@pytest.mark.parametrize("cards,in_job,device,logged", [
    (2, False, "cuda", True),
    (1, False, "cuda", False),
    (2, True, "cuda", False),
    (2, False, "cpu", False),
])
def test_one_card_line(cards, in_job, device, logged, log_lines, monkeypatch):
    from m6anet_tpu_torch.parallel.group import note_one_card
    from m6anet_tpu_torch.utils.logging import get_logger

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    if in_job:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
    note_one_card(torch.device(device), get_logger("m6anet_tpu_torch.test"), "--distributed")
    notes = [line for line in log_lines if "uses one card" in line]
    assert len(notes) == int(logged)
    if logged:
        assert "torchrun --nproc_per_node 2" in notes[0] and "--distributed" in notes[0]


@pytest.mark.parametrize("subcommand,flag", [("inference", "--distributed"), ("train", "--use_mesh on")])
def test_the_clis_log_the_one_card_line(subcommand, flag, log_lines, monkeypatch, tmp_path):
    """Outside a job on a box of two cards, each CLI logs the line once
    and then runs as before (here stopped right after, at its first use of
    the card)."""
    from m6anet_tpu_torch.cli import main
    from m6anet_tpu_torch.inference import engine

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(engine, "resolve_device", lambda device: torch.device("cuda", 0))
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    if subcommand == "inference":
        from m6anet_tpu_torch.scripts import inference

        monkeypatch.setattr(inference, "_score", stop)
        argv = ["inference", "--input_dir", DATA_DIR, "--out_dir", str(tmp_path)]
    else:
        from m6anet_tpu_torch.models import mil

        monkeypatch.setattr(mil.MILModel, "to", stop)
        argv = ["train", "--train_config", os.path.join(DATA_DIR, "sample_config.toml"), "--save_dir", str(tmp_path)]
    with pytest.raises(Stop):
        main(argv)
    notes = [line for line in log_lines if "uses one card" in line]
    assert len(notes) == 1 and flag in notes[0]
