"""The port's inference engine and CLI on the CPU.

Held three ways on the demo data: against the golden CSVs at the reference
suite's tolerances (indiv 1e-5, mod_ratio 1e-6, site 1e-2; 1.5e-2 for the
MC method, as tests/test_inference.py), against the JAX engine's CSVs on the
same data (indiv 1e-6, site 1e-5 — the port sums 1 - p in f64 — and
mod_ratio equal), and through analogs of the JAX engine's own tests (resume,
empty input, small batches, site-only output, oversized sites, MC
determinism)."""
import os
import subprocess
import sys
import tomllib

import jax  # noqa: F401  (jax before torch, see conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch

from m6anet_tpu.constants import PRETRAINED_CONFIGS as JAX_PRETRAINED
from m6anet_tpu.data.dataset import build_dataset as jax_build_dataset
from m6anet_tpu.inference.engine import run_inference as jax_run_inference
from m6anet_tpu_torch.constants import (
    DEFAULT_MIN_READS,
    DEFAULT_MODEL_CONFIG,
    PRETRAINED_CONFIGS,
)
from m6anet_tpu_torch.data.batching import pack_sites
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.inference.engine import run_inference
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.ops import fused_infer_kernel, mc_kernel, random, site_ops

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS_I = ["transcript_id", "transcript_position", "read_index"]
KEYS_S = ["transcript_id", "transcript_position"]


def _model(name="HCT116_RNA002"):
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        return load_model(tomllib.load(f), PRETRAINED_CONFIGS[name][0])


def _dataset(min_reads=DEFAULT_MIN_READS):
    _, _, norm = PRETRAINED_CONFIGS["HCT116_RNA002"]
    return build_dataset(DATA_DIR, min_reads=min_reads, norm_path=norm, mode="Inference")


THRESHOLD = PRETRAINED_CONFIGS["HCT116_RNA002"][1]


def _run(out_dir, **kwargs):
    kwargs.setdefault("device", "cpu")
    run_inference(_model(), _dataset(), str(out_dir), THRESHOLD, **kwargs)


def _sorted(df, cols):
    return df.sort_values(cols).reset_index(drop=True)


@pytest.fixture(scope="module")
def port_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_inference")
    _run(out)
    return out


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory, production_model):
    out = tmp_path_factory.mktemp("jax_inference")
    model, params = production_model
    _, thr, norm = JAX_PRETRAINED["HCT116_RNA002"]
    ds = jax_build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")
    jax_run_inference(model, params, ds, str(out), read_proba_threshold=thr, backend="xla")
    return out


def _compare(got_dir, want_i, want_s, indiv_atol, site_atol, mod_ratio_atol, rows=(5595, 101)):
    got_i = _sorted(pd.read_csv(os.path.join(got_dir, "data.indiv_proba.csv")), KEYS_I)
    got_s = _sorted(pd.read_csv(os.path.join(got_dir, "data.site_proba.csv")), KEYS_S)
    want_i, want_s = _sorted(want_i, KEYS_I), _sorted(want_s, KEYS_S)
    assert (len(got_i), len(got_s)) == (len(want_i), len(want_s)) == rows
    for col in KEYS_I:
        assert (got_i[col] == want_i[col]).all()
    for col in KEYS_S + ["n_reads", "kmer"]:
        assert (got_s[col] == want_s[col]).all()
    np.testing.assert_allclose(got_i.probability_modified, want_i.probability_modified, rtol=0, atol=indiv_atol)
    np.testing.assert_allclose(got_s.probability_modified, want_s.probability_modified, rtol=0, atol=site_atol)
    np.testing.assert_allclose(got_s.mod_ratio, want_s.mod_ratio, rtol=0, atol=mod_ratio_atol)


def test_matches_golden(port_out, golden_indiv_proba, golden_site_proba):
    _compare(port_out, pd.read_csv(golden_indiv_proba), pd.read_csv(golden_site_proba),
             indiv_atol=1e-5, site_atol=1e-2, mod_ratio_atol=1e-6)


def test_matches_jax_engine(port_out, jax_out):
    _compare(
        port_out,
        pd.read_csv(os.path.join(jax_out, "data.indiv_proba.csv")),
        pd.read_csv(os.path.join(jax_out, "data.site_proba.csv")),
        indiv_atol=1e-6, site_atol=1e-5, mod_ratio_atol=0,
    )


def test_csv_order_and_format_match_jax_engine(port_out, jax_out):
    """Same rows in the same order, same columns, 16 decimals."""
    for name, keys in (("data.site_proba.csv", KEYS_S), ("data.indiv_proba.csv", KEYS_I)):
        got = pd.read_csv(os.path.join(port_out, name), dtype=str)
        want = pd.read_csv(os.path.join(jax_out, name), dtype=str)
        assert list(got.columns) == list(want.columns)
        assert (got[keys].values == want[keys].values).all()
        assert got.probability_modified.str.match(r"^\d\.\d{16}$").all()


def test_resume(port_out, tmp_path):
    """Kill-and-resume: truncated outputs continue to an identical result."""
    broken = tmp_path / "broken"
    broken.mkdir()
    site_lines = (port_out / "data.site_proba.csv").read_text().splitlines(keepends=True)
    (broken / "data.site_proba.csv").write_text("".join(site_lines[:38]) + "ENST0000partial")
    kept_reads = sum(int(line.split(",")[2]) for line in site_lines[1:38])
    indiv_lines = (port_out / "data.indiv_proba.csv").read_text().splitlines(keepends=True)
    (broken / "data.indiv_proba.csv").write_text("".join(indiv_lines[: 1 + kept_reads + 3]))
    _run(broken, resume=True)
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (broken / name).read_bytes() == (port_out / name).read_bytes()


def test_resume_from_empty_files_writes_headers(port_out, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    (out / "data.site_proba.csv").write_text("")
    (out / "data.indiv_proba.csv").write_text("")
    _run(out, resume=True)
    assert (out / "data.site_proba.csv").read_bytes() == (port_out / "data.site_proba.csv").read_bytes()


def test_empty_dataset(tmp_path):
    """Zero qualifying sites still produce valid header-only CSVs."""
    _, _, norm = PRETRAINED_CONFIGS["HCT116_RNA002"]
    ds = build_dataset(DATA_DIR, min_reads=10**6, norm_path=norm, mode="Inference")
    assert len(ds) == 0
    run_inference(_model(), ds, str(tmp_path), THRESHOLD, device="cpu")
    site = pd.read_csv(tmp_path / "data.site_proba.csv")
    indiv = pd.read_csv(tmp_path / "data.indiv_proba.csv")
    assert len(site) == 0 and len(indiv) == 0
    assert list(site.columns) == engine.SITE_HEADER.strip().split(",")
    assert list(indiv.columns) == engine.INDIV_HEADER.strip().split(",")


@pytest.mark.parametrize("pipeline_depth", [1, 3])
def test_small_batches_identical(port_out, tmp_path, pipeline_depth):
    """Multi-batch packing (tiny capacities) and any pipeline depth write
    the same bytes as one big batch."""
    _run(tmp_path, read_capacity=1024, site_capacity=8, pipeline_depth=pipeline_depth)
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (tmp_path / name).read_bytes() == (port_out / name).read_bytes()


def test_site_only_mode(port_out, tmp_path):
    """write_indiv=False writes an identical site CSV, no indiv CSV, and
    resumes on the site file alone."""
    site_only = tmp_path / "site_only"
    _run(site_only, write_indiv=False)
    want = (port_out / "data.site_proba.csv").read_bytes()
    assert (site_only / "data.site_proba.csv").read_bytes() == want
    assert not (site_only / "data.indiv_proba.csv").exists()

    lines = (port_out / "data.site_proba.csv").read_text().splitlines(keepends=True)
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "data.site_proba.csv").write_text("".join(lines[:20]) + "torn")
    _run(broken, write_indiv=False, resume=True)
    assert (broken / "data.site_proba.csv").read_bytes() == want


def test_replicates_match_jax_engine(tmp_path, production_model):
    """Two input dirs are replicates: reads pooled per site, read ids
    suffixed with the replicate number (string ids take the Python CSV
    renderer)."""
    import shutil

    rep = tmp_path / "rep1"
    rep.mkdir()
    for name in ("data.info", "data.json"):
        shutil.copyfile(os.path.join(DATA_DIR, name), rep / name)
    norm = PRETRAINED_CONFIGS["HCT116_RNA002"][2]
    ds = build_dataset([DATA_DIR, str(rep)], min_reads=DEFAULT_MIN_READS, norm_path=norm)
    run_inference(_model(), ds, str(tmp_path / "port"), THRESHOLD, device="cpu")
    model, params = production_model
    jax_ds = jax_build_dataset([DATA_DIR, str(rep)], min_reads=DEFAULT_MIN_READS,
                               norm_path=JAX_PRETRAINED["HCT116_RNA002"][2])
    jax_run_inference(model, params, jax_ds, str(tmp_path / "jax"), read_proba_threshold=THRESHOLD,
                      backend="xla")
    want_i = pd.read_csv(tmp_path / "jax" / "data.indiv_proba.csv")
    want_s = pd.read_csv(tmp_path / "jax" / "data.site_proba.csv")
    # pooled sites reach 1,324 reads, where the JAX engine's f32 sums of
    # 1 - p drift past 1e-5: hold site_p to the closed form over the JAX
    # engine's per-read p, evaluated in f64, instead
    exact = want_i.groupby(KEYS_S).probability_modified.apply(
        lambda p: 1.0 - np.mean(1.0 - p.to_numpy(np.float64)) ** 20
    )
    want_s["probability_modified"] = exact.loc[list(zip(want_s.transcript_id, want_s.transcript_position))].to_numpy()
    _compare(tmp_path / "port", want_i, want_s,
             indiv_atol=1e-6, site_atol=1e-5, mod_ratio_atol=0, rows=(13186, 171))


def test_computed_norm_factors_match_jax():
    """Without --norm_path the dataset computes per-kmer factors itself."""
    got = build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=None).norm_dict
    want = jax_build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=None).norm_dict
    assert sorted(got) == sorted(want)
    for kmer in want:
        np.testing.assert_array_equal(got[kmer][0], want[kmer][0])
        np.testing.assert_array_equal(got[kmer][1], want[kmer][1])


def test_oversized_site_raises(tmp_path):
    with pytest.raises(ValueError, match="read_capacity"):
        list(pack_sites(_dataset().iter_sites(), read_capacity=128, site_capacity=4))
    with pytest.raises(ValueError, match="read_capacity"):
        _run(tmp_path, read_capacity=128, site_capacity=4)


def test_merge_host_shards(port_out, tmp_path):
    """Shards written per host concatenate back into the single-run files."""
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        lines = (port_out / name).read_text().splitlines(keepends=True)
        cut = len(lines) // 2
        (tmp_path / f"{name}.shard0").write_text("".join(lines[:cut]))
        (tmp_path / f"{name}.shard1").write_text(lines[0] + "".join(lines[cut:]))
    engine.merge_host_shards(str(tmp_path), 2)
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (tmp_path / name).read_bytes() == (port_out / name).read_bytes()


def test_backend_resolution():
    model = _model()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert engine.production_architecture(model)
    assert fused_infer_kernel.kernel_limit(fused_infer_kernel.model_widths(model)) is None
    assert engine.resolve_backend(model, "auto", "auto", cpu) == ("torch", "f32")
    # auto is f32x3 on the CUDA backends, f32 on torch (the JAX package's
    # resolution: pallas backends f32x3, xla f32)
    assert engine.resolve_backend(model, "auto", "auto", cuda) == ("cuda_fused", "f32x3")
    assert engine.resolve_backend(model, "cuda_fused", "auto", cuda) == ("cuda_fused", "f32x3")
    assert engine.resolve_backend(model, "torch", "auto", cuda) == ("torch", "f32")
    assert engine.resolve_backend(model, "torch", "f32", cuda) == ("torch", "f32")
    for precision in ("f32", "f32x3", "bf16"):
        assert engine.resolve_backend(model, "auto", precision, cuda) == ("cuda_fused", precision)
    # the production architecture at other widths: the JAX package runs it
    # on its width-generic Pallas kernel, and so does the port on its
    # kernels built for those widths (past their fast plans, on their wide
    # ones); a vocabulary past the int16 k-mer ids raises, naming the limit
    # and --backend torch
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        config = tomllib.load(f)
    config["block"][4]["output_channel"] = config["block"][5]["input_channel"] = 16
    narrow = load_model(config)
    assert engine.production_architecture(narrow)
    assert fused_infer_kernel.kernel_limit(fused_infer_kernel.model_widths(narrow)) is None
    assert engine.resolve_backend(narrow, "auto", "auto", cpu) == ("torch", "f32")
    assert engine.resolve_backend(narrow, "torch", "auto", cuda) == ("torch", "f32")
    for backend in ("auto", "cuda_fused"):
        assert engine.resolve_backend(narrow, backend, "auto", cuda) == ("cuda_fused", "f32x3")
    config["block"][4]["output_channel"] = config["block"][5]["input_channel"] = 65
    wide = load_model(config)
    assert engine.production_architecture(wide)
    assert fused_infer_kernel.kernel_limit(fused_infer_kernel.model_widths(wide)) is None
    for backend in ("auto", "cuda_fused"):
        assert engine.resolve_backend(wide, backend, "auto", cuda) == ("cuda_fused", "f32x3")
    assert engine.resolve_backend(wide, "cuda", "bf16", cuda) == ("cuda", "bf16")
    config["block"][1]["input_channel"] = 32768
    vast = load_model(config)
    assert engine.production_architecture(vast)
    assert "int16 k-mer ids" in fused_infer_kernel.kernel_limit(fused_infer_kernel.model_widths(vast))
    for backend in ("auto", "cuda_fused", "cuda"):
        with pytest.raises(ValueError, match="hidden 150 -> 65.*int16 k-mer ids.*--backend torch"):
            engine.resolve_backend(vast, backend, "auto", cuda)
    with pytest.raises(ValueError, match="needs device 'cuda'"):
        engine.resolve_backend(model, "cuda_fused", "auto", cpu)
    # the reduced modes need a CUDA backend, as the JAX package's need a
    # Pallas one
    for backend, device in (("torch", cuda), ("torch", cpu), ("auto", cpu)):
        for precision in ("f32x3", "bf16"):
            with pytest.raises(ValueError, match="CUDA backends.*torch"):
                engine.resolve_backend(model, backend, precision, device)
    with pytest.raises(ValueError, match="precision must be one of"):
        engine.resolve_backend(model, "auto", "f16", cuda)
    with pytest.raises(ValueError, match="exact.*mc"):
        engine.make_infer_step(model, 16, THRESHOLD, method="sampled")
    # the encoder-kernel backend: a card and the production architecture
    assert engine.resolve_backend(model, "cuda", "auto", cuda) == ("cuda", "f32x3")
    assert engine.resolve_backend(model, "cuda", "bf16", cuda) == ("cuda", "bf16")
    with pytest.raises(ValueError, match="backend 'cuda' needs device 'cuda'"):
        engine.resolve_backend(model, "cuda", "auto", cpu)
    assert engine.resolve_backend(narrow, "cuda", "auto", cuda) == ("cuda", "f32x3")


def test_default_device_without_a_card_raises(tmp_path, monkeypatch):
    """The entry points default to CUDA and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_inference(_model(), _dataset(), str(tmp_path), THRESHOLD)
    assert not (tmp_path / "data.site_proba.csv").exists()
    from m6anet_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["inference", "--input_dir", DATA_DIR, "--out_dir", str(tmp_path / "cli")])
    assert not (tmp_path / "cli").exists()


@pytest.mark.parametrize(
    "flags",
    [
        ["--site_proba_method", "mc", "--columnar"],
        ["--columnar"],
        ["--concat_shards"],
        ["--distributed"],
        ["--host_shard", "0", "2"],
        ["--num_iterations", "100", "--distributed"],
        ["--seed", "1", "--concat_shards"],
    ],
)
def test_unported_flags_fail_at_parse_time(flags, tmp_path):
    """Named for what it held while these flags' paths were not ported:
    they stopped the parse.  Their paths are ported now
    (tests/test_torch_columnar.py, tests/test_torch_distributed.py), and
    they parse to the JAX package's values."""
    from m6anet_tpu.scripts import inference as jax_inference
    from m6anet_tpu_torch.scripts import inference

    argv = ["--input_dir", DATA_DIR, "--out_dir", str(tmp_path), "--device", "cpu", *flags]
    ours = vars(inference.argparser().parse_args(argv))
    theirs = vars(jax_inference.argparser().parse_args(argv))
    for key in ("columnar", "concat_shards", "distributed", "host_shard", "site_proba_method", "num_iterations",
                "seed", "input_dir"):
        assert ours[key] == theirs[key], key
    assert not any(tmp_path.iterdir())


def test_relay_fetch_flag_is_not_accepted(tmp_path, capsys):
    """--fetch_group tuned the JAX engine's grouped fetches; the port copies
    each batch's outputs back once and has no such knob."""
    from m6anet_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main(["inference", "--input_dir", DATA_DIR, "--out_dir", str(tmp_path), "--device", "cpu",
              "--fetch_group", "4"])
    assert exc.value.code == 2
    assert "--fetch_group" in capsys.readouterr().err


def test_cli_subprocess_on_cpu(port_out, tmp_path):
    """`python -m m6anet_tpu_torch inference --device cpu` writes the same
    bytes as the Python entry point, and reports no kernel launch."""
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "m6anet_tpu_torch", "inference", "--input_dir", DATA_DIR,
         "--out_dir", str(out), "--device", "cpu", "--n_processes", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "backend=torch" in proc.stderr
    assert "batches dispatched: 1" in proc.stderr
    assert ('kernel launches: {"fused_inference_t": 0, "fused_read_probability": 0, "read_prob_tail": 0, '
            '"site_probability_mc": 0, "fused_inference": 0, "site_reduce": 0, "read_prob_tc_f32x3": 0, '
            '"read_prob_tc_bf16": 0, "read_prob_wide_f32": 0, "read_prob_wide_f32x3": 0, "read_prob_wide_bf16": 0, '
            '"read_prob_grouped": 0, "site_probability_mc_long": 0}') in proc.stderr
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (out / name).read_bytes() == (port_out / name).read_bytes()


def test_cli_accepts_the_mc_flags_and_the_cuda_backend(tmp_path):
    from m6anet_tpu_torch.cli import main
    from m6anet_tpu_torch.scripts.inference import argparser

    base = ["--input_dir", DATA_DIR, "--out_dir", str(tmp_path)]
    args = argparser().parse_args(base)
    assert (args.site_proba_method, args.num_iterations, args.seed, args.backend) == ("exact", 1000, 0, "auto")
    args = argparser().parse_args(
        base + ["--site_proba_method", "mc", "--num_iterations", "50", "--seed", "3", "--backend", "cuda"])
    assert (args.site_proba_method, args.num_iterations, args.seed, args.backend) == ("mc", 50, 3, "cuda")
    # the run: the seed reaches the engine (same bytes as the Python entry point)
    main(["inference", *base, "--device", "cpu", "--site_proba_method", "mc", "--num_iterations", "50",
          "--seed", "3", "--n_processes", "2"])
    _run(tmp_path / "direct", method="mc", num_iterations=50, seed=3)
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (tmp_path / name).read_bytes() == (tmp_path / "direct" / name).read_bytes()
    # --backend cuda needs the card
    with pytest.raises(ValueError, match="needs device 'cuda'"):
        main(["inference", *base, "--device", "cpu", "--backend", "cuda"])


@pytest.fixture(scope="module")
def port_mc_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_mc")
    _run(out, method="mc", num_iterations=100, seed=7)
    return out


def test_mc_matches_jax_engine(port_mc_out, tmp_path, production_model):
    """The torch backend's MC against the JAX engine's xla backend, same
    seed: the same draws, so site 1e-5 (f32 sums in another order)."""
    model, params = production_model
    _, thr, norm = JAX_PRETRAINED["HCT116_RNA002"]
    ds = jax_build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")
    jax_run_inference(model, params, ds, str(tmp_path), read_proba_threshold=thr, backend="xla",
                      method="mc", num_iterations=100, seed=7)
    _compare(
        port_mc_out,
        pd.read_csv(tmp_path / "data.indiv_proba.csv"),
        pd.read_csv(tmp_path / "data.site_proba.csv"),
        indiv_atol=1e-6, site_atol=1e-5, mod_ratio_atol=0,
    )


def test_mc_matches_golden(tmp_path, golden_indiv_proba, golden_site_proba):
    """MC sampling at 2,000 iterations against the golden CSVs (made with the
    reference's own MC), at tests/test_inference.py:61's tolerance."""
    _run(tmp_path, method="mc", num_iterations=2000)
    _compare(tmp_path, pd.read_csv(golden_indiv_proba), pd.read_csv(golden_site_proba),
             indiv_atol=1e-5, site_atol=1.5e-2, mod_ratio_atol=1e-6)


def test_mc_deterministic_and_placement_invariant(port_mc_out, tmp_path):
    """Same seed gives the same bytes (tests/test_inference.py:78); other
    batching gives the same draws per site, so the same values up to the
    order of the f32 sums, which torch picks by the batch's site count;
    another seed moves the site values."""
    _run(tmp_path / "again", method="mc", num_iterations=100, seed=7)
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (tmp_path / "again" / name).read_bytes() == (port_mc_out / name).read_bytes()
    _run(tmp_path / "small", method="mc", num_iterations=100, seed=7, read_capacity=1024, site_capacity=8)
    small = pd.read_csv(tmp_path / "small" / "data.site_proba.csv")
    want = pd.read_csv(port_mc_out / "data.site_proba.csv")
    assert (small[KEYS_S].values == want[KEYS_S].values).all()
    np.testing.assert_allclose(small.probability_modified, want.probability_modified, rtol=0, atol=1e-6)
    _run(tmp_path / "other", method="mc", num_iterations=100, seed=8)
    a = pd.read_csv(port_mc_out / "data.site_proba.csv").probability_modified
    b = pd.read_csv(tmp_path / "other" / "data.site_proba.csv").probability_modified
    assert (a != b).sum() > 50


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
@pytest.mark.parametrize("method", ["exact", "mc"])
def test_cuda_backend_steps_on_cpu_tensors(backend, method):
    """The CUDA backends' per-batch steps, run on CPU tensors (each wrapper
    then takes its plain version), agree with the torch backend's step: p
    1e-6, mod_ratio equal, exact site_p 1e-5; the MC site_p is the MC
    kernel's function over the shared draws of the seed."""
    model = _model().eval()
    batch = next(iter(pack_sites(_dataset().iter_sites(), read_capacity=4096, site_capacity=64)))
    args = [torch.from_numpy(a) for a in (batch.features, batch.kmer_ids, batch.offsets, batch.counts)]
    kw = dict(method=method, n_iterations=300, seed=5)
    with torch.no_grad():
        step = engine.make_infer_step(model, 64, THRESHOLD, 20, backend=backend, **kw)
        got = step(*args)
        want = engine.make_infer_step(model, 64, THRESHOLD, 20, backend="torch", **kw)(*args)
        # the engine's call, with the batch's host offsets, counts and k-mer ids
        hosted = step(*args, host_sites=(batch.offsets, batch.counts),
                      host_kmer_ids=fused_infer_kernel.checked_kmer_ids(batch.kmer_ids))
    assert all(torch.equal(a, b) for a, b in zip(got, hosted))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    if method == "exact":
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    else:
        u = torch.from_numpy(random.shared_draws(5, 300))
        mc = mc_kernel.site_probability_mc_plain(got[0], args[2], args[3], u, 300)
        torch.testing.assert_close(got[1], mc, rtol=0, atol=0)
        # the two backends draw differently; both estimate the closed form
        exact = site_ops.site_probability_exact(
            got[0], site_ops.derive_site_ids(args[2], args[3], 4096, 64), args[3], 64)
        real = args[3] > 0
        assert float((got[1] - exact)[real].abs().max()) < 5e-2
        assert float((want[1] - exact)[real].abs().max()) < 5e-2


def test_cuda_backends_take_the_mc_kernels_samples():
    """The MC kernel builds for any n_samples from 1: the CUDA backends
    take another n_samples than mc_kernel.SAMPLES, as the torch backend
    does, and on CPU tensors the step gives the plain version's values."""
    model = _model().eval()
    rng = np.random.default_rng(4)
    features = torch.from_numpy(rng.normal(size=(16, 9)).astype(np.float32))
    kmer = torch.from_numpy(rng.integers(0, 66, size=(16, 3)).astype(np.int8))
    offsets = torch.tensor([0, 3, 0, 0], dtype=torch.int32)
    counts = torch.tensor([3, 12, 0, 0], dtype=torch.int32)
    for backend in ("cuda_fused", "cuda"):
        step = engine.make_infer_step(model, 4, THRESHOLD, 7, "mc", backend, n_iterations=10)
        with torch.no_grad():
            p, site_p, _ = step(features, kmer, offsets, counts)
        u = torch.from_numpy(random.shared_draws(0, 10, 7))
        want = mc_kernel.site_probability_mc_plain(p, offsets, counts, u, 10, 7)
        assert torch.equal(site_p, want), backend
    engine.make_infer_step(model, 4, THRESHOLD, 7, "mc", "torch", n_iterations=10)


def test_mc_read_window_is_checked_before_the_launch():
    """On the CUDA backends a site above the reads the MC kernels' draw
    index takes (mc_kernel.MAX_SITE_READS, 2^23 - 1) fails the step before
    the MC kernel launches, naming --backend torch (the JAX engine's check,
    engine.py:572-577, names --backend xla); a site above the staged cap is
    taken."""
    model = _model().eval()
    step = engine.make_infer_step(model, 4, THRESHOLD, 20, "mc", "cuda_fused", n_iterations=10)
    big = mc_kernel.MAX_SITE_READS + 1
    rng = np.random.default_rng(2)
    features = torch.from_numpy(rng.normal(size=(16, 9)).astype(np.float32))
    kmer = torch.from_numpy(rng.integers(0, 66, size=(16, 3)).astype(np.int8))
    offsets = torch.tensor([0, 3, 0, 0], dtype=torch.int32)
    counts = torch.tensor([3, big, 0, 0], dtype=torch.int32)
    before = mc_kernel.launch_count
    with torch.no_grad(), pytest.raises(ValueError, match=f"{big} reads.*--backend torch"):
        step(features, kmer, offsets, counts, host_sites=(offsets.numpy(), counts.numpy()))
    assert mc_kernel.launch_count == before
    long = mc_kernel.MAX_STAGED_READS + 1
    features = torch.from_numpy(rng.normal(size=(long + 8, 9)).astype(np.float32))
    kmer = torch.from_numpy(rng.integers(0, 66, size=(long + 8, 3)).astype(np.int8))
    counts = torch.tensor([3, long, 0, 0], dtype=torch.int32)
    with torch.no_grad():
        _, site_p, _ = step(features, kmer, offsets, counts)
    assert bool(torch.isfinite(site_p).all()) and float(site_p[1]) > 0


def test_compare_runs_holds_each_rule(tmp_path):
    """inference.outputs.compare_runs, the comparison of two runs' CSVs
    every port check makes: a run against itself passes; a read moved past
    read_atol, a site moved past site_atol + 20 max|dp| of its reads, a
    mod_ratio moved off the threshold, a row missing or a NaN each fail it;
    a mod_ratio at a site holding a read across the threshold may move."""
    from m6anet_tpu_torch.inference.outputs import compare_runs

    base = tmp_path / "base"
    run_inference(_model(), _dataset(), str(base), THRESHOLD, device="cpu")
    assert compare_runs(str(base), str(base), THRESHOLD, 0.0, 0.0)["ok"]

    def edited(name, edit):
        out = tmp_path / name
        out.mkdir()
        for csv in ("data.indiv_proba.csv", "data.site_proba.csv"):
            frame = pd.read_csv(base / csv)
            changed = edit(csv, frame)
            frame = frame if changed is None else changed
            frame.to_csv(out / csv, index=False, float_format="%.16f")
        return str(out)

    site = pd.read_csv(base / "data.site_proba.csv").iloc[0]
    at_site = lambda f: (f.transcript_id == site.transcript_id) & (f.transcript_position == site.transcript_position)

    def read(delta):
        def edit(csv, f):
            if csv == "data.indiv_proba.csv":
                f.loc[f.index[at_site(f)][0], "probability_modified"] += delta
        return edit

    def site_p(delta):
        def edit(csv, f):
            if csv == "data.site_proba.csv":
                f.loc[at_site(f), "probability_modified"] += delta
        return edit

    def mod_ratio(csv, f):
        if csv == "data.site_proba.csv":
            f.loc[at_site(f), "mod_ratio"] += 0.05

    gaps = compare_runs(edited("read", read(2e-6)), str(base), THRESHOLD, 1e-6)
    assert not gaps["ok"] and gaps["reads_over_read_atol"] == 1
    assert compare_runs(str(tmp_path / "read"), str(base), THRESHOLD, 3e-6)["ok"]
    assert not compare_runs(edited("site", site_p(2e-5)), str(base), THRESHOLD, 1e-6)["ok"]
    assert compare_runs(str(tmp_path / "site"), str(base), THRESHOLD, 1e-6, None)["ok"]  # reads alone
    # the site's allowance grows by 20 max|dp| of its reads
    assert compare_runs(edited("both", lambda c, f: read(1e-6)(c, f) or site_p(2e-5)(c, f)), str(base),
                        THRESHOLD, 1e-6)["ok"]
    assert not compare_runs(edited("mod_ratio", mod_ratio), str(base), THRESHOLD, 1e-6)["ok"]
    # a read moved across the threshold frees its site's mod_ratio
    first = pd.read_csv(base / "data.indiv_proba.csv")
    p0 = first.probability_modified[at_site(first)].iloc[0]
    across = edited("across", lambda c, f: read(2 * (THRESHOLD - p0))(c, f) or mod_ratio(c, f))
    gaps = compare_runs(across, str(base), THRESHOLD, 1.0, 1.0)
    assert gaps["ok"] and gaps["sites_near_threshold"] == 1
    gaps = compare_runs(edited("nan", read(float("nan"))), str(base), THRESHOLD, 1.0, 1.0)
    assert not gaps["ok"] and not gaps["finite"]
    short = edited("short", lambda c, f: f.iloc[1:] if c == "data.site_proba.csv" else None)
    assert not compare_runs(short, str(base), THRESHOLD, 1.0, 1.0)["same_rows"]
