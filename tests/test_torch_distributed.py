"""The port's multi-process runs on the CPU: host shards, ``--distributed``
inference and data-parallel training (``train --use_mesh on``), held
against one-process runs and the JAX package.

* Host shards 0..k-1, merged, give the one-process CSVs byte for byte
  (uneven shards, exact and MC, data.json and the columnar store), and
  ``resume`` inside a shard finishes that shard's own files.
* ``--distributed``: two gloo processes through the CLI give the
  one-process bytes; a failing rank makes every rank exit non-zero and
  nothing is merged; without a launcher's environment the CLI raises.
* Data-parallel training: the two-rank gloo step on the JAX loader's padded
  batches (``TrainLoader(pad_to_multiple=2)``) against the one-process step
  on the same batches and the JAX package's step, at ``PERF.md`` §2
  "Training" tolerances (loss 1e-6 relative, parameters 1e-6 but 2 lr where
  the gradient is below 1e-6; BatchNorm statistics 1e-6); one rank is the
  one-process step bit for bit.

Every spawned process gets a free port and a timeout of its own, so that no
hang outlasts the test run.
"""
import filecmp
import os
import signal
import socket
import subprocess
import sys

import jax  # noqa: F401  (jax before torch, see conftest.py)
import numpy as np
import pytest
import torch

from m6anet_tpu.constants import DEFAULT_NORM_PATH as JAX_NORM_PATH
from m6anet_tpu.data import loader as jax_loader
from m6anet_tpu.data.dataset import SiteDataset as JaxSiteDataset
from m6anet_tpu.models.mil import MILModel as JaxMILModel
from m6anet_tpu.parallel.mesh import host_shard_bounds as jax_host_shard_bounds
from m6anet_tpu.train import loop as jax_loop
from m6anet_tpu.train import losses as jax_losses
from m6anet_tpu_torch.constants import (
    DEFAULT_MIN_READS,
    DEFAULT_MODEL_CONFIG,
    DEFAULT_NORM_PATH,
    PRETRAINED_CONFIGS,
    TRAIN_CONFIG_TEMPLATE,
)
from m6anet_tpu_torch.data.columnar import ColumnarSiteDataset
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference.engine import merge_host_shards, run_inference
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.models.blocks import Linear
from m6anet_tpu_torch.models.convert import params_from_jax, params_to_jax
from m6anet_tpu_torch.models.mil import MILModel
from m6anet_tpu_torch.parallel.mesh import host_shard_bounds
from m6anet_tpu_torch.train import loop, losses
from m6anet_tpu_torch.utils.config import dump_toml, load_toml

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_distributed_worker.py")
MODEL_PATH, THRESHOLD, NORM = PRETRAINED_CONFIGS["HCT116_RNA002"]
NAMES = ("data.site_proba.csv", "data.indiv_proba.csv")
LR, WD, CLIP = 4e-3, 1e-5, 5.0
PROCESS_TIMEOUT = 240  # seconds, for each spawned process


def _model():
    return load_model(load_toml(DEFAULT_MODEL_CONFIG), MODEL_PATH)


def _same_files(got_dir, want_dir, names=NAMES):
    for name in names:
        assert filecmp.cmp(os.path.join(got_dir, name), os.path.join(want_dir, name), shallow=False), name


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A columnar store of the demo's sites, written by the port's writer
    from tests/data's data.json."""
    from m6anet_tpu_torch.data.columnar import ColumnarWriter
    from m6anet_tpu_torch.data.dataset import SiteDataset

    root = str(tmp_path_factory.mktemp("store"))
    raw = SiteDataset(DATA_DIR, min_reads=0, norm_path=None)
    raw.norm_dict = None
    writer = ColumnarWriter(root, 3)
    for site in raw.iter_sites():
        writer.append_site(site.tx_id, site.tx_pos, site.sequence, site.features, site.read_ids)
    writer.finalize()
    return root


def _dataset(feed, store):
    if feed == "columnar":
        return ColumnarSiteDataset(store, min_reads=DEFAULT_MIN_READS, norm_path=NORM)
    return build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=NORM, mode="Inference")


MC = dict(method="mc", num_iterations=50, seed=3)


# ------------------------------------------------------------ host shards
def test_host_shard_bounds_match_jax():
    for n_items in (0, 1, 7, 10, 101, 1000):
        for n_hosts in (1, 2, 3, 4, 7, 16):
            spans = [host_shard_bounds(n_items, n_hosts, h) for h in range(n_hosts)]
            assert spans == [jax_host_shard_bounds(n_items, n_hosts, h) for h in range(n_hosts)]
            assert [i for s, e in spans for i in range(s, e)] == list(range(n_items))


@pytest.mark.parametrize("method", ["exact", "mc"])
@pytest.mark.parametrize("feed", ["json", "columnar"])
def test_host_shards_merge_to_the_whole_run(feed, method, store, tmp_path):
    """4 shards of the demo's 101 sites (26, 26, 26, 23), each in batches
    of 16 sites: merged, the one-process bytes."""
    kw = dict(MC if method == "mc" else {}, read_capacity=2048, site_capacity=16, device="cpu")
    model, dataset = _model(), _dataset(feed, store)
    assert len(dataset) == 101
    run_inference(model, dataset, str(tmp_path / "whole"), THRESHOLD, **kw)
    for host in range(4):
        run_inference(model, dataset, str(tmp_path / "shards"), THRESHOLD, host_shard=(host, 4), **kw)
    rows = [len(open(tmp_path / "shards" / f"data.site_proba.csv.shard{h}").readlines()) - 1 for h in range(4)]
    assert rows == [26, 26, 26, 23]
    merge_host_shards(str(tmp_path / "shards"), 4)
    _same_files(tmp_path / "shards", tmp_path / "whole")


@pytest.mark.parametrize("feed", ["json", "columnar"])
def test_resume_inside_a_shard(feed, store, tmp_path):
    """An interrupted shard (a torn site row, the read rows of sites past
    the last whole one) resumes within its own files to the bytes of an
    uninterrupted run of that shard."""
    kw = dict(read_capacity=1024, site_capacity=8, device="cpu", host_shard=(1, 3))
    model, dataset = _model(), _dataset(feed, store)
    run_inference(model, dataset, str(tmp_path / "full"), THRESHOLD, **kw)
    names = [f"{name}.shard1" for name in NAMES]
    site_rows = (tmp_path / "full" / names[0]).read_text().splitlines(keepends=True)
    indiv_rows = (tmp_path / "full" / names[1]).read_text().splitlines(keepends=True)
    cut = 11  # header + 10 sites, then half of the 11th row
    n_reads = sum(int(row.split(",")[2]) for row in site_rows[1:cut])
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / names[0]).write_text("".join(site_rows[:cut]) + site_rows[cut][:9])
    (tmp_path / "torn" / names[1]).write_text("".join(indiv_rows[: 1 + n_reads + 5]))
    run_inference(model, dataset, str(tmp_path / "torn"), THRESHOLD, resume=True, **kw)
    _same_files(tmp_path / "torn", tmp_path / "full", names)


def test_host_shard_outside_the_hosts_raises(tmp_path):
    with pytest.raises(ValueError, match="host id 2"):
        run_inference(_model(), _dataset("json", None), str(tmp_path), THRESHOLD, device="cpu", host_shard=(2, 2))


def test_host_shard_cli_merges_to_the_whole_cli_run(tmp_path):
    from m6anet_tpu_torch.cli import main

    base = ["inference", "--input_dir", DATA_DIR, "--device", "cpu", "--site_capacity", "32"]
    main([*base, "--out_dir", str(tmp_path / "whole")])
    for host in range(2):
        main([*base, "--out_dir", str(tmp_path / "shards"), "--host_shard", str(host), "2"])
    merge_host_shards(str(tmp_path / "shards"), 2)
    _same_files(tmp_path / "shards", tmp_path / "whole")


# ------------------------------------------------------------ processes
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(argv, world, timeout=PROCESS_TIMEOUT):
    """``argv`` in ``world`` processes, as torchrun would start them; each
    is killed (with its process group) past ``timeout`` seconds.  Returns
    ``(returncode, stdout, stderr)`` by rank."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, start_new_session=True))
    results = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
            out, err = proc.communicate()
            pytest.fail(f"a rank of {argv[:4]} outlasted {timeout} s: {err[-2000:]}")
        results.append((proc.returncode, out, err))
    return results


CLI = [sys.executable, "-m", "m6anet_tpu_torch"]


@pytest.mark.parametrize("method", ["exact", "mc"])
def test_distributed_cli_gives_the_one_process_bytes(method, store, tmp_path):
    flags = ["--site_proba_method", "mc", "--num_iterations", "50", "--seed", "3"] if method == "mc" else []
    if method == "mc":  # the MC run reads the columnar store
        flags += ["--columnar"]
        input_dir = store
    else:
        input_dir = DATA_DIR
    base = ["inference", "--input_dir", input_dir, "--device", "cpu", "--site_capacity", "32", *flags]
    from m6anet_tpu_torch.cli import main

    main([*base, "--out_dir", str(tmp_path / "one")])
    results = _launch([*CLI, *base, "--out_dir", str(tmp_path / "two"), "--distributed"], 2)
    for rank, (code, _, err) in enumerate(results):
        assert code == 0, err[-3000:]
        assert "backend gloo" in err and f"rank {rank} of 2" in err
    _same_files(tmp_path / "two", tmp_path / "one")
    for host in range(2):  # the shards stay beside the merged files
        assert os.path.exists(tmp_path / "two" / f"data.site_proba.csv.shard{host}")


def test_a_failing_rank_fails_the_job_and_nothing_is_merged(tmp_path):
    out = tmp_path / "out"
    (out / "data.site_proba.csv.shard1").mkdir(parents=True)  # rank 1 cannot write its shard
    results = _launch([*CLI, "inference", "--input_dir", DATA_DIR, "--device", "cpu", "--out_dir", str(out),
                       "--distributed"], 2)
    assert [code != 0 for code, _, _ in results] == [True, True]
    assert "rank(s) failed" in results[0][2] and "IsADirectoryError" in results[0][2]
    assert not (out / "data.site_proba.csv").exists() and not (out / "data.indiv_proba.csv").exists()


def test_distributed_without_a_launcher_raises(tmp_path, monkeypatch):
    from m6anet_tpu_torch.cli import main

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="missing: WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        main(["inference", "--input_dir", DATA_DIR, "--out_dir", str(tmp_path), "--device", "cpu", "--distributed"])
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------ training
@pytest.fixture(scope="module")
def padded_batches():
    """The JAX loader's batches of the demo's Train split, 25 sites a batch,
    the last of 7 wrap-padded to 8 (``pad_to_multiple=2``), with each row's
    mask as the train loop makes it."""
    np.random.seed(5)
    ds = JaxSiteDataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=JAX_NORM_PATH, mode="Train")
    batches = []
    for batch in jax_loader.TrainLoader(ds, batch_size=25, num_workers=1, pad_to_multiple=2):
        batch = dict(batch)
        n_valid = batch.pop("n_valid")
        batch["mask"] = (np.arange(len(batch["y"])) < n_valid).astype(np.float32)
        batches.append(batch)
    assert [len(b["y"]) for b in batches] == [26, 26, 8] and batches[-1]["mask"].sum() == 7
    return batches


def _start_state(source):
    model = MILModel(load_toml(DEFAULT_MODEL_CONFIG))
    if source == "init":
        model.init(torch.Generator().manual_seed(0))
    else:
        model = _model()
    return {k: v.clone() for k, v in model.state_dict().items()}


def _one_process(state, batches):
    """The one-process steps: each step's loss, predictions and state."""
    model = MILModel(load_toml(DEFAULT_MODEL_CONFIG))
    model.load_state_dict(state)
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, loop.make_optimizer(model, LR, WD), CLIP)
    step_losses, preds, states = [], [], []
    for b in batches:
        loss, pred = step({k: torch.from_numpy(v) for k, v in b.items()})
        step_losses.append(loss)
        preds.append(pred)
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return torch.stack(step_losses), preds, states


def _jax_steps(state, batches):
    """The JAX package's steps from the same state: each step's loss and
    parameters (as a port state)."""
    jax_model = JaxMILModel(load_toml(DEFAULT_MODEL_CONFIG))
    params = params_to_jax(state)
    optimizer = jax_loop.make_optimizer(LR, WD, CLIP)
    jax_step = jax_loop.make_train_step(jax_model, jax_losses.binary_cross_entropy_loss, optimizer)
    opt_state = optimizer.init(params)
    step_losses, states = [], []
    for i, batch in enumerate(batches):
        params, opt_state, loss, _ = jax_step(params, opt_state, batch, jax.random.PRNGKey(i))
        step_losses.append(float(loss))
        states.append(params_from_jax(jax.tree.map(np.asarray, params)))
    return np.array(step_losses), states


def _dropout_inputs():
    block = Linear(9, 16, activation="relu", batch_norm=True, dropout=0.25)
    block.init(torch.Generator().manual_seed(2))
    start = {k: v.clone() for k, v in block.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 9)).astype(np.float32))
    with torch.no_grad():
        want = block(x, train=True, generator=torch.Generator().manual_seed(1))
    return start, x, want, block.bn.running_mean.clone()


def _run_workers(world, state, batches, tmp_path):
    dropout_state, x, _, _ = _dropout_inputs()
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"state": state, "batches": batches, "lr": LR, "wd": WD, "clip": CLIP,
                "dropout_state": dropout_state, "dropout_x": x}, inputs)
    results = _launch([sys.executable, WORKER, inputs, str(tmp_path / "out")], world)
    for code, _, err in results:
        assert code == 0, err[-3000:]
    return [torch.load(tmp_path / f"out.rank{r}.pt", weights_only=False) for r in range(world)]


def _held(got_state, want_state, grads_small, param_atol=1e-6):
    """Each leaf within ``param_atol``, but 2 lr where the gradient is
    below 1e-6; the BatchNorm statistics within 1e-6."""
    got, want = params_to_jax(got_state), params_to_jax(want_state)
    for blk in want:
        for leaf, w in want[blk].items():
            g = np.asarray(got[blk][leaf])
            loose = grads_small.get((blk, leaf), np.zeros(np.shape(w), bool))
            diff = np.abs(g - np.asarray(w))
            assert diff[~loose].max(initial=0) <= param_atol, (blk, leaf, diff.max())
            assert diff[loose].max(initial=0) <= 2 * LR, (blk, leaf, diff.max())


def _small_grads(state, batch):
    model = MILModel(load_toml(DEFAULT_MODEL_CONFIG))
    model.load_state_dict(state)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses.binary_cross_entropy_loss(model.site_probability(t, train=True), t["y"], mask=t["mask"]).backward()
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    return {(blk, leaf): np.abs(np.asarray(g)) < 1e-6 for blk in grads for leaf, g in grads[blk].items()}


@pytest.mark.parametrize("source", ["init", "HCT116_RNA002"])
def test_two_rank_step_matches_one_process_and_jax(source, padded_batches, tmp_path):
    """The first step at the one-step tolerances; all three steps (the
    last on a wrap-padded batch) with each loss within 1e-5 relative of
    the one-process port's and 1e-4 of the JAX package's (two steps on
    let the unresolved elements drift, PERF.md "Training") and every final
    parameter within 2 lr."""
    state = _start_state(source)
    ranks = _run_workers(2, state, padded_batches, tmp_path)
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    # every rank holds the same global results, bit for bit
    assert torch.equal(ranks[0]["losses"], ranks[1]["losses"])
    for k in ranks[0]["states"][-1]:
        assert torch.equal(ranks[0]["states"][-1][k], ranks[1]["states"][-1][k]), k
    got = ranks[0]
    want_losses, want_preds, want_states = _one_process(state, padded_batches)
    jax_losses_seen, jax_states = _jax_steps(state, padded_batches)
    small = _small_grads(state, padded_batches[0])
    for ref_loss, ref_state in ((float(want_losses[0]), want_states[0]), (jax_losses_seen[0], jax_states[0])):
        assert abs(float(got["losses"][0]) - ref_loss) <= 1e-6 * abs(ref_loss)
        _held(got["states"][0], ref_state, small)
    np.testing.assert_allclose(got["preds"][0].numpy(), want_preds[0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["losses"].numpy(), want_losses.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["losses"].numpy(), jax_losses_seen, rtol=1e-4)
    for ref_state in (want_states[-1], jax_states[-1]):
        _held(got["states"][-1], ref_state, {}, param_atol=2 * LR)
    # dropout: rank r's rows of the one-process draw; BatchNorm statistics
    # of the global batch
    _, _, want, running_mean = _dropout_inputs()
    dropped = torch.cat([r["dropout"] for r in ranks])
    assert torch.equal(dropped == 0, want == 0)
    torch.testing.assert_close(dropped, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got["dropout_running_mean"], running_mean, rtol=0, atol=1e-6)


def test_one_rank_step_is_the_one_process_step_bit_for_bit(padded_batches, tmp_path):
    state = _start_state("HCT116_RNA002")
    (rank,) = _run_workers(1, state, padded_batches, tmp_path)
    want_losses, want_preds, want_states = _one_process(state, padded_batches)
    assert torch.equal(rank["losses"], want_losses)
    assert all(torch.equal(a, b) for a, b in zip(rank["preds"], want_preds))
    for k in want_states[-1]:
        assert torch.equal(rank["states"][-1][k], want_states[-1][k]), k
    _, _, want, _ = _dropout_inputs()
    assert torch.equal(rank["dropout"], want)


def test_two_rank_train_cli(tmp_path):
    """``train --use_mesh on`` over two gloo ranks on the demo: rank 0
    alone prints and writes the JAX layout."""
    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=DATA_DIR, norm_path=DEFAULT_NORM_PATH)
    cfg_path = str(tmp_path / "train.toml")
    dump_toml(cfg, cfg_path)
    out = tmp_path / "out"
    results = _launch([*CLI, "train", "--train_config", cfg_path, "--save_dir", str(out), "--device", "cpu",
                       "--epochs", "2", "--save_per_epoch", "2", "--num_iterations", "1", "--lr", "4e-3",
                       "--use_mesh", "on"], 2)
    for code, _, err in results:
        assert code == 0, err[-3000:]
    (_, out0, err0), (_, out1, _) = results
    assert "Data-parallel training over 2 ranks" in out0 and "There are 57 train sites" in out0
    assert "Epoch:[2/2]" in out0 and "Epoch" not in out1 and "There are" not in out1
    assert "backend gloo" in err0
    assert sorted(os.listdir(out / "model_states" / "2")) == ["meta.json", "model_states.npz", "opt_state.npz"]
    for name in ("avg_loss.npz", "roc_auc.npz", "pr_auc.npz", "train_info.toml", "train_results.json",
                 "val_results.json", "test_results_avg_loss.json"):
        assert (out / name).exists(), name
    import json

    with open(out / "train_results.json") as f:
        assert np.isfinite(json.load(f)["avg_loss"]).all()
