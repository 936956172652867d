"""Every released model end to end on the demo: the port's engine against the
JAX engine's ``xla`` run, on the CPU.

The port's analog of tests/test_all_models_demo.py.  Each model runs with
its own weights, read threshold and norm factors (arabidopsis_RNA002 has its
own threshold and factors; the two RNA004 models take HCT116's factors), as
``--pretrained_model`` picks them.

Tolerances.  Both packages compute in f32, in different summation orders,
so each sits some way from the exact value, and how far depends on the
model: on the demo the JAX engine's p is within 1.3e-7 of an f64 evaluation
for HCT116_RNA002 but 7.8e-7 for HEK293T_RNA004, where the port's is 1.0e-6
off and the two 1.4e-6 apart.  So per read the port is held to the JAX
engine within max(1e-6, 2 e), e the JAX engine's own largest distance from
the f64 evaluation on the same reads, and to the f64 evaluation within the
same bound; per site within 1e-5 + 20 max|dp| over the site's reads (the
derivative of 1 - m**20 is at most 20, and the mean m moves by at most
max|dp|: on the demo arabidopsis_RNA002's reads sit below 1e-6 apart, but
in one direction, and move a site by 1.2e-5); the mod_ratio equal but at sites holding a read within 1e-6 of the threshold or
on the other side of it.  HCT116_RNA002 is also held to the golden CSVs
(indiv 1e-5, mod_ratio 1e-6, site 1e-2).  The fused kernels' plain versions
(what the CUDA backends run on a CPU tensor) are held to the torch step per
model at 1e-6.
"""
import os
import tomllib

import jax  # noqa: F401  (jax before torch, see conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch

from m6anet_tpu import constants as jax_constants
from m6anet_tpu.data.dataset import build_dataset as jax_build_dataset
from m6anet_tpu.inference.engine import run_inference as jax_run_inference
from m6anet_tpu.models import load_model as jax_load_model
from m6anet_tpu_torch.constants import DEFAULT_MIN_READS, DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
from m6anet_tpu_torch.data.batching import pack_sites
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.inference.outputs import compare_runs
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.ops import fused_infer_kernel

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
KEYS_I = ["transcript_id", "transcript_position", "read_index"]
KEYS_S = ["transcript_id", "transcript_position"]


def _config():
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        return tomllib.load(f)


def _read(out, name, keys):
    return pd.read_csv(os.path.join(out, name)).sort_values(keys).reset_index(drop=True)


def _compare(got_dir, want_i, want_s, indiv_atol, site_atol, mod_ratio_atol):
    got_i = _read(got_dir, "data.indiv_proba.csv", KEYS_I)
    got_s = _read(got_dir, "data.site_proba.csv", KEYS_S)
    assert (len(got_i), len(got_s)) == (len(want_i), len(want_s)) == (5595, 101)
    assert (got_i[KEYS_I].values == want_i[KEYS_I].values).all()
    for col in KEYS_S + ["n_reads", "kmer"]:
        assert (got_s[col] == want_s[col]).all()
    np.testing.assert_allclose(got_i.probability_modified, want_i.probability_modified, rtol=0, atol=indiv_atol)
    np.testing.assert_allclose(got_s.probability_modified, want_s.probability_modified, rtol=0, atol=site_atol)
    np.testing.assert_allclose(got_s.mod_ratio, want_s.mod_ratio, rtol=0, atol=mod_ratio_atol)


def test_the_four_models_take_the_jax_packages_settings():
    assert sorted(PRETRAINED_CONFIGS) == sorted(jax_constants.PRETRAINED_CONFIGS)
    for name, (weights, threshold, norm) in PRETRAINED_CONFIGS.items():
        jax_weights, jax_threshold, jax_norm = jax_constants.PRETRAINED_CONFIGS[name]
        assert threshold == jax_threshold, name
        for ours, theirs in ((weights, jax_weights), (norm, jax_norm)):
            assert os.path.basename(ours) == os.path.basename(theirs)
            with np.load(ours) as a, np.load(theirs) as b:
                assert sorted(a.files) == sorted(b.files)
                assert all(np.array_equal(a[k], b[k]) for k in a.files), name
    assert PRETRAINED_CONFIGS["arabidopsis_RNA002"][1] != PRETRAINED_CONFIGS["HCT116_RNA002"][1]


def _f64_read_probs(name, ds):
    """p of every demo read from an f64 copy of the port's model, keyed as
    the indiv CSV."""
    model = load_model(_config(), PRETRAINED_CONFIGS[name][0]).double()
    rows, features, kmers = [], [], []
    for site in ds.iter_sites():
        rows += [(site.tx_id, site.tx_pos, int(r)) for r in site.read_ids]
        features.append(site.features)
        kmers.append(np.repeat(site.kmer_ids[None, :], len(site.features), axis=0))
    with torch.no_grad():
        p = model.per_read_probability({
            "X": torch.from_numpy(np.concatenate(features)).double(),
            "kmer": torch.from_numpy(np.concatenate(kmers).astype(np.int64)),
        }).numpy()
    index = pd.MultiIndex.from_tuples(rows, names=KEYS_I)
    return pd.Series(p, index=index)


@pytest.mark.parametrize("name", sorted(PRETRAINED_CONFIGS))
def test_demo_inference_matches_the_jax_engine(name, tmp_path, golden_indiv_proba, golden_site_proba):
    weights, threshold, norm = PRETRAINED_CONFIGS[name]
    jax_weights, jax_threshold, jax_norm = jax_constants.PRETRAINED_CONFIGS[name]
    jax_model, jax_params = jax_load_model(_config(), jax_weights)
    jax_ds = jax_build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=jax_norm, mode="Inference")
    jax_run_inference(jax_model, jax_params, jax_ds, str(tmp_path / "jax"), read_proba_threshold=jax_threshold,
                      backend="xla")
    ds = build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")
    engine.run_inference(load_model(_config(), weights), ds, str(tmp_path / "port"), threshold, device="cpu")
    want_i = _read(tmp_path / "jax", "data.indiv_proba.csv", KEYS_I)
    exact = _f64_read_probs(name, ds).loc[pd.MultiIndex.from_frame(want_i[KEYS_I])].values
    read_atol = max(1e-6, 2 * np.abs(want_i.probability_modified.values - exact).max())
    gaps = compare_runs(str(tmp_path / "port"), str(tmp_path / "jax"), threshold, read_atol)
    assert gaps["ok"] and gaps["rows"] == [5595, 101], gaps
    got_i = _read(tmp_path / "port", "data.indiv_proba.csv", KEYS_I)
    np.testing.assert_allclose(got_i.probability_modified.values, exact, rtol=0, atol=read_atol)
    if name == "HCT116_RNA002":
        golden_i = pd.read_csv(golden_indiv_proba).sort_values(KEYS_I).reset_index(drop=True)
        golden_s = pd.read_csv(golden_site_proba).sort_values(KEYS_S).reset_index(drop=True)
        _compare(tmp_path / "port", golden_i, golden_s, indiv_atol=1e-5, site_atol=1e-2, mod_ratio_atol=1e-6)


def _demo_batch(norm):
    ds = build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")
    (batch,) = pack_sites(ds.iter_sites(), read_capacity=8192, site_capacity=128)
    return batch


@pytest.mark.parametrize("name", sorted(PRETRAINED_CONFIGS))
def test_fused_steps_plain_versions_match_the_torch_step_per_model(name):
    """The CUDA backends' steps on CPU tensors (every kernel wrapper then runs
    its plain version), at f32, against the torch step, on the demo's one
    packed batch with the model's own weights and threshold."""
    weights, threshold, norm = PRETRAINED_CONFIGS[name]
    model = load_model(_config(), weights)
    batch = _demo_batch(norm)
    host_kmer = fused_infer_kernel.checked_kmer_ids(batch.kmer_ids)
    inputs = [torch.from_numpy(a) for a in (batch.features, host_kmer.ids, batch.offsets, batch.counts)]
    kw = dict(host_sites=(batch.offsets, batch.counts), host_kmer_ids=host_kmer)
    with torch.no_grad():
        want = engine.make_infer_step(model, 128, threshold)(*inputs, **kw)
        for backend in engine.CUDA_BACKENDS:
            got = engine.make_infer_step(model, 128, threshold, backend=backend, precision="f32")(*inputs, **kw)
            n = int(batch.counts.sum())
            np.testing.assert_allclose(got[0][:n], want[0][:n], rtol=0, atol=1e-6, err_msg=backend)
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5, err_msg=backend)
            np.testing.assert_array_equal(got[2], want[2], err_msg=backend)
