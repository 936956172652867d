"""The port's columnar site store and concatenated shards on the CPU, held
against the JAX package.

The store is the JAX package's dataprep output (``--format both``) on the
demo eventalign.txt, so data.json and the columnar store hold the same
sites.  Held:

* the port's ``ColumnarSiteDataset`` gives the JAX package's sites bit for
  bit, and the port's data.json ``SiteDataset``'s raw sites bit for bit;
* computed norm factors within 1e-6 relative of the JAX package's;
* the port's ``ColumnarWriter`` writes the JAX writer's files byte for byte;
* ``iter_packed`` gives ``pack_sites(iter_sites())``'s arrays bit for bit,
  so the engine's columnar feed computes the generic feed's CSVs byte for
  byte;
* inference on the store against the JAX engine on the store (per read
  1e-6, site 1e-5 + 20 max|dp|, mod_ratio equal off the threshold,
  ``inference.outputs.compare_runs``), for one store, replicates and
  concatenated shards, columnar and data.json.

The columnar store holds raw features as f32 and normalises in f32; the
data.json path parses the decimal text to f64 and normalises in f64 (both
packages).  So ``--columnar`` and data.json give CSVs that differ in the
last bits: they are held at the JAX package's own bound for that gap
(``tests/test_columnar.py``: 5e-5 per read), and their gap is reported.
"""
import filecmp
import os
import shutil

import jax  # noqa: F401  (jax before torch, see conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch  # noqa: F401

from m6anet_tpu.data import columnar as jax_columnar
from m6anet_tpu.data.dataset import ConcatSiteDataset as JaxConcat
from m6anet_tpu.inference.engine import run_inference as jax_run_inference
from m6anet_tpu_torch.constants import DEFAULT_MIN_READS, PRETRAINED_CONFIGS
from m6anet_tpu_torch.data import columnar
from m6anet_tpu_torch.data.batching import pack_sites
from m6anet_tpu_torch.data.dataset import ConcatSiteDataset, SiteDataset
from m6anet_tpu_torch.inference.engine import run_inference
from m6anet_tpu_torch.inference.outputs import compare_runs

MODEL_PATH, THRESHOLD, NORM = PRETRAINED_CONFIGS["HCT116_RNA002"]
NAMES = ("data.site_proba.csv", "data.indiv_proba.csv")
STORE_FILES = ("features.f32.bin", "read_ids.i64.bin", "site_offsets.npy", "site_tx.npy", "site_pos.npy",
               "site_seq.npy", "transcripts.txt", "meta.json")
# the JAX package's bound between its columnar and data.json runs
# (tests/test_columnar.py): f32 against f64 normalisation
JSON_READ_ATOL = 5e-5


def _dataprep(out, host_shard=None):
    from m6anet_tpu.dataprep import run_dataprep

    run_dataprep(os.path.join(os.path.dirname(__file__), "data", "eventalign.txt"), str(out), n_processes=1,
                 readcount_min=1, readcount_max=1000, min_segment_count=1, n_neighbors=1,
                 output_format="both", host_shard=host_shard)
    return str(out)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return _dataprep(tmp_path_factory.mktemp("columnar_store"))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The demo's dataprep in two host shards (by transcript)."""
    root = tmp_path_factory.mktemp("columnar_shards")
    return [_dataprep(root / f"shard{h}", host_shard=(h, 2)) for h in range(2)]


@pytest.fixture(scope="module")
def model():
    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG
    from m6anet_tpu_torch.models import load_model

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        return load_model(tomllib.load(f), MODEL_PATH)


def _same_site(a, b):
    assert (a.tx_id, a.tx_pos, a.sequence) == (b.tx_id, b.tx_pos, b.sequence)
    np.testing.assert_array_equal(a.read_ids, b.read_ids)
    np.testing.assert_array_equal(a.kmer_ids, b.kmer_ids)
    assert a.features.dtype == b.features.dtype == np.float32
    np.testing.assert_array_equal(a.features, b.features)


@pytest.mark.parametrize("norm_path", [None, NORM], ids=["raw", "normalised"])
def test_sites_match_the_jax_store_and_data_json(store, norm_path):
    compute = norm_path is not None
    port = columnar.ColumnarSiteDataset(store, min_reads=1, norm_path=norm_path, compute_norm=compute)
    jax_ds = jax_columnar.ColumnarSiteDataset(store, min_reads=1, norm_path=norm_path, compute_norm=compute)
    assert len(port) == len(jax_ds) > 100
    for i in range(len(port)):
        _same_site(port.get_site(i), jax_ds.get_site(i))
    if norm_path is None:  # the raw features: data.json's decimals as f32
        js = SiteDataset(store, min_reads=1, norm_path=None)
        js.norm_dict = None
        assert len(js) == len(port)
        for a, b in zip(port.iter_sites(), js.iter_sites()):
            _same_site(a, b)


def test_computed_norm_factors_match_jax(store):
    got = columnar.ColumnarSiteDataset(store, min_reads=DEFAULT_MIN_READS).norm_dict
    want = jax_columnar.ColumnarSiteDataset(store, min_reads=DEFAULT_MIN_READS).norm_dict
    assert sorted(got) == sorted(want) and len(want) > 5
    for kmer in want:
        for g, w in zip(got[kmer], want[kmer]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    rep = columnar.ReplicateColumnarDataset([store, store + "/."], min_reads=DEFAULT_MIN_READS).norm_dict
    jax_rep = jax_columnar.ReplicateColumnarDataset([store, store + "/."], min_reads=DEFAULT_MIN_READS).norm_dict
    for kmer in jax_rep:
        for g, w in zip(rep[kmer], jax_rep[kmer]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_writer_files_are_byte_identical_to_the_jax_writer(store, tmp_path):
    src = jax_columnar.ColumnarSiteDataset(store, min_reads=0, compute_norm=False)
    writers = [columnar.ColumnarWriter(str(tmp_path / "port"), 3),
               jax_columnar.ColumnarWriter(str(tmp_path / "jax"), 3)]
    for raw in range(len(src.site_pos)):
        lo, hi = int(src.offsets[raw]), int(src.offsets[raw + 1])
        args = (src.transcripts[src.site_tx[raw]], int(src.site_pos[raw]), src.site_seq[raw].decode(),
                np.asarray(src.features[lo:hi]), np.asarray(src.read_ids[lo:hi]))
        for w in writers:
            w.append_site(*args)
    for w in writers:
        w.finalize()
    for name in STORE_FILES:
        port = tmp_path / "port" / "columnar" / name
        assert port.read_bytes() == (tmp_path / "jax" / "columnar" / name).read_bytes(), name
        # and the dataprep's own store
        assert port.read_bytes() == open(os.path.join(store, "columnar", name), "rb").read(), name


def _batch_arrays(batch):
    return [batch.features, batch.kmer_ids, batch.site_ids, batch.offsets, batch.counts, batch.global_ids]


@pytest.mark.parametrize(
    "read_capacity,site_capacity,start,limit,min_reads",
    [
        (1024, 16, 0, None, DEFAULT_MIN_READS),
        (301, 7, 5, 40, DEFAULT_MIN_READS),  # ragged capacities, a slice of the sites
        (2048, 64, 0, None, 1),  # no holes: one block copy a batch
        (500, 3, 17, 9, 35),  # holes between kept sites: per-site gathers
    ],
)
def test_iter_packed_equals_pack_sites(store, read_capacity, site_capacity, start, limit, min_reads):
    ds = columnar.ColumnarSiteDataset(store, min_reads=min_reads, norm_path=NORM)
    jax_ds = jax_columnar.ColumnarSiteDataset(store, min_reads=min_reads, norm_path=NORM)
    assert len(ds) < len(ds.offsets) - 1 or min_reads == 1  # the filter leaves holes
    stop = None if limit is None else start + limit
    sites = (ds.get_site(i) for i in range(start, len(ds) if stop is None else min(stop, len(ds))))
    want = list(pack_sites(sites, read_capacity=read_capacity, site_capacity=site_capacity))
    got = list(ds.iter_packed(start, limit, read_capacity, site_capacity))
    jax_got = list(jax_ds.iter_packed(start, limit, read_capacity, site_capacity))
    assert len(got) == len(want) == len(jax_got) > 1
    for g, w, j in zip(got, want, jax_got):
        for a, b, c in zip(_batch_arrays(g), _batch_arrays(w), _batch_arrays(j)):
            assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert [(s.tx_id, s.tx_pos, s.center_kmer) for s in g.sites] == [
            (s.tx_id, s.tx_pos, s.center_kmer) for s in w.sites]
        for s, t in zip(g.sites, w.sites):
            np.testing.assert_array_equal(s.read_ids, t.read_ids)


def test_missing_store_names_the_dataprep_format(tmp_path):
    with pytest.raises(FileNotFoundError, match="--format columnar"):
        columnar.ColumnarSiteDataset(str(tmp_path))
    from m6anet_tpu_torch.cli import main

    with pytest.raises(FileNotFoundError, match="--format columnar"):
        main(["inference", "--input_dir", str(tmp_path), "--out_dir", str(tmp_path / "out"), "--device", "cpu",
              "--columnar"])


class _GenericFeed:
    """A dataset's sites without its ``iter_packed``: the engine then packs
    them with ``pack_sites``, as for data.json."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.max_site_reads = dataset.max_site_reads

    def __len__(self):
        return len(self.dataset)

    def iter_sites(self, n_threads=1):
        return self.dataset.iter_sites(n_threads)


@pytest.fixture(scope="module")
def columnar_cli_out(store, tmp_path_factory):
    from m6anet_tpu_torch.cli import main

    out = str(tmp_path_factory.mktemp("columnar_cli"))
    main(["inference", "--input_dir", store, "--out_dir", out, "--device", "cpu", "--columnar",
          "--read_capacity", "2048", "--site_capacity", "32"])
    return out


def test_columnar_feed_gives_the_generic_feeds_bytes(store, model, columnar_cli_out, tmp_path):
    ds = columnar.ColumnarSiteDataset(store, min_reads=DEFAULT_MIN_READS, norm_path=NORM)
    run_inference(model, _GenericFeed(ds), str(tmp_path), THRESHOLD, device="cpu",
                  read_capacity=2048, site_capacity=32)
    for name in NAMES:
        assert filecmp.cmp(os.path.join(columnar_cli_out, name), tmp_path / name, shallow=False), name


def _jax_run(production_model, dataset, out):
    jax_model, params = production_model
    jax_run_inference(jax_model, params, dataset, str(out), read_proba_threshold=THRESHOLD, backend="xla")
    return str(out)


def _hold(got, want, read_atol=1e-6, site_atol=1e-5):
    gaps = compare_runs(got, want, THRESHOLD, read_atol, site_atol)
    assert gaps["ok"], gaps
    return gaps


def test_columnar_cli_matches_the_jax_engine_and_data_json(store, columnar_cli_out, production_model, tmp_path):
    jax_ds = jax_columnar.ColumnarSiteDataset(store, min_reads=DEFAULT_MIN_READS, norm_path=NORM)
    jax_out = _jax_run(production_model, jax_ds, tmp_path / "jax")
    gaps = _hold(columnar_cli_out, jax_out)
    assert gaps["rows"] == [5595, 101]
    from m6anet_tpu_torch.cli import main

    main(["inference", "--input_dir", store, "--out_dir", str(tmp_path / "json"), "--device", "cpu"])
    json_gaps = _hold(columnar_cli_out, str(tmp_path / "json"), read_atol=JSON_READ_ATOL, site_atol=None)
    assert 0 < json_gaps["indiv"] < JSON_READ_ATOL  # f32 against f64 normalisation


def test_replicate_columnar_matches_the_jax_engine(store, production_model, tmp_path):
    rep = tmp_path / "rep2"
    shutil.copytree(store, rep)
    from m6anet_tpu_torch.cli import main

    main(["inference", "--input_dir", store, str(rep), "--out_dir", str(tmp_path / "port"), "--device", "cpu",
          "--columnar"])
    jax_ds = jax_columnar.ReplicateColumnarDataset([store, str(rep)], min_reads=DEFAULT_MIN_READS, norm_path=NORM)
    _jax_run(production_model, jax_ds, tmp_path / "jax")
    got = pd.read_csv(tmp_path / "port" / "data.indiv_proba.csv")
    assert got.read_index.astype(str).str.endswith(("_0", "_1")).all()
    # pooled sites reach ~2,600 reads, where the JAX engine's f32 sums of
    # 1 - p drift past 1e-5 (tests/test_torch_engine.py's replicate test):
    # the sites are held by their reads alone
    gaps = _hold(str(tmp_path / "port"), str(tmp_path / "jax"), site_atol=None)
    assert gaps["rows"][0] > 2 * 5595


@pytest.mark.parametrize("use_columnar", [True, False], ids=["columnar", "json"])
def test_concat_shards_match_the_jax_engine_and_the_whole(store, shards, use_columnar, production_model, tmp_path):
    from m6anet_tpu_torch.cli import main

    flags = ["--columnar"] if use_columnar else []
    main(["inference", "--input_dir", *shards, "--out_dir", str(tmp_path / "port"), "--device", "cpu",
          "--concat_shards", *flags])
    jax_ds = JaxConcat(shards, columnar=use_columnar, min_reads=DEFAULT_MIN_READS, norm_path=NORM, mode="Inference")
    _jax_run(production_model, jax_ds, tmp_path / "jax")
    _hold(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the shards hold the whole dataset's sites in its order: the same bytes
    main(["inference", "--input_dir", store, "--out_dir", str(tmp_path / "whole"), "--device", "cpu", *flags])
    for name in NAMES:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "whole" / name, shallow=False), name
    port = ConcatSiteDataset(shards, columnar=use_columnar, min_reads=DEFAULT_MIN_READS, norm_path=NORM)
    assert len(port) == len(jax_ds) and port.max_site_reads == jax_ds.max_site_reads
    for i in (0, len(port) // 2, len(port) - 1):
        _same_site(port.get_site(i), jax_ds.get_site(i))


def test_concat_shards_need_a_norm_path(shards):
    for use_columnar in (True, False):
        with pytest.raises(ValueError, match="explicit norm_path"):
            ConcatSiteDataset(shards, columnar=use_columnar, norm_path=None)


def test_columnar_train_loaders_match_data_json(store, tmp_path):
    """``[dataset] format = "columnar"`` builds the data.json builder's
    loaders: the same sites, labels, k-mers and read draws for one seed;
    features within the f32-against-f64 normalisation gap."""
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH, TRAIN_CONFIG_TEMPLATE
    from m6anet_tpu_torch.train.builder import build_dataloader
    from m6anet_tpu_torch.utils.config import load_toml

    # the demo's labelled data.json, and a store of its sites written by
    # the port's writer (data.info.labelled carries the golden data.json's
    # byte offsets)
    root = tmp_path / "labelled"
    root.mkdir()
    for name in ("data.json", "data.info", "data.info.labelled"):
        shutil.copyfile(os.path.join(os.path.dirname(__file__), "data", name), root / name)
    raw = SiteDataset(str(root), min_reads=0, norm_path=None)
    raw.norm_dict = None
    writer = columnar.ColumnarWriter(str(root), 3)
    for site in raw.iter_sites():
        writer.append_site(site.tx_id, site.tx_pos, site.sequence, site.features, site.read_ids)
    writer.finalize()
    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=str(root), norm_path=DEFAULT_NORM_PATH)
    runs = {}
    for fmt in ("json", "columnar"):
        cfg["dataset"]["format"] = fmt
        np.random.seed(7)
        loaders = build_dataloader(cfg, 1, verbose=False)
        runs[fmt] = [[b for b in dl] for dl in loaders for _ in range(2)]
    n = 0
    for got_loader, want_loader in zip(runs["columnar"], runs["json"]):
        assert len(got_loader) == len(want_loader) > 0
        for got, want in zip(got_loader, want_loader):
            np.testing.assert_array_equal(got["y"], want["y"])
            np.testing.assert_array_equal(got["kmer"], want["kmer"])
            assert got["n_valid"] == want["n_valid"]
            np.testing.assert_allclose(got["X"], want["X"], rtol=1e-5, atol=1e-5)
            n += len(got["y"])
    assert n > 100
    with pytest.raises(ValueError, match="single root_dir"):
        cfg["dataset"].update(format="columnar", root_dir=[str(root), str(root)])
        build_dataloader(cfg, 1, verbose=False)
