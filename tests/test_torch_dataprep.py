"""The port's dataprep (``m6anet_tpu_torch.dataprep``, its native parser and
``scripts/dataprep.py``) against the goldens and the JAX package.

* The goldens (``tests/data``, made with ``--min_segment_count 1
  --n_neighbors 1``): eventalign.index as a sorted frame, data.info's sites
  and read counts, and each site's payload after sorting its reads (the
  reference's read order differs), as ``tests/test_dataprep.py`` holds the
  JAX package.
* The JAX dataprep on the same input and flags: every output file byte for
  byte (eventalign.index, data.info, data.json, data.log and the columnar
  store), over the output formats, ``--compress``, ``--n_neighbors 2``, the
  readcount gates and both ``--host_shard`` halves.
* The port against itself: parallel against serial (the native core's own
  threads on), gzip input against plain, and the numpy path (no native
  library) against the native path by record, on the demo and on
  adversarial input.
* The JAX suite's edge cases: malformed lines, interleaved transcripts,
  header-only input, the completion trailer, and the index loader's CRLF
  and malformed rows.
"""
import filecmp
import gzip
import json
import os
import shutil
import time

import jax  # noqa: F401  (jax before torch, see conftest.py)
import numpy as np
import pandas as pd
import pytest

from m6anet_tpu.dataprep import run_dataprep as jax_run_dataprep
from m6anet_tpu_torch import native
from m6anet_tpu_torch.dataprep import combine, indexer, is_successful, read_last_line, run_dataprep, runner, windowing

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
EVENTALIGN = os.path.join(DATA_DIR, "eventalign.txt")
HEADER = ("contig\tposition\treference_kmer\tread_index\tstrand\tevent_index\tevent_level_mean\tevent_stdv\t"
          "event_length\tmodel_kmer\tmodel_mean\tmodel_stdv\tstandardized_level\tstart_idx\tend_idx\n")
GOLDEN_FLAGS = dict(readcount_min=1, readcount_max=1000, min_segment_count=1, n_neighbors=1)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library, loaded.  It builds in place at
    first use, so a test worker can load it half-written while another
    worker compiles it (ROADMAP Queue 3); that worker then keeps the numpy
    fallback, whose data.json differs in bytes.  Load it again once the
    file is whole: these tests need the JAX native path as the reference."""
    import m6anet_tpu.native as jax_native_mod

    deadline = time.monotonic() + 120
    while jax_native_mod.get_lib() is None:
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native library does not load")
        time.sleep(2)
        jax_native_mod._build_failed = False
    return jax_native_mod


@pytest.fixture(scope="module")
def port_demo(tmp_path_factory):
    """The port's dataprep on the demo, as the goldens were made."""
    out = str(tmp_path_factory.mktemp("port_demo"))
    run_dataprep(EVENTALIGN, out, n_processes=2, output_format="both", **GOLDEN_FLAGS)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files)


def _assert_same_bytes(got, want):
    assert _files(got) == _files(want)
    for name in _files(want):
        assert filecmp.cmp(os.path.join(got, name), os.path.join(want, name), shallow=False), name


def _read_site(json_path, tx_id, tx_pos, start, end):
    with open(json_path, encoding="utf-8") as f:
        f.seek(start)
        payload = json.loads(f.read(end - start))[tx_id][str(tx_pos)]
    assert len(payload) == 1
    kmer, features = next(iter(payload.items()))
    features = np.asarray(features)
    return kmer, features[:, -1].astype(int), features[:, :-1]


def _sorted_info(path):
    return pd.read_csv(path).sort_values(["transcript_id", "transcript_position"]).reset_index(drop=True)


def test_index_matches_golden(tmp_path):
    out = indexer.build_index(EVENTALIGN, str(tmp_path))
    got = pd.read_csv(out).sort_values(["transcript_id", "read_index"]).reset_index(drop=True)
    want = pd.read_csv(os.path.join(DATA_DIR, "eventalign.index")).sort_values(
        ["transcript_id", "read_index"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)


def test_dataprep_matches_golden(port_demo):
    got = _sorted_info(os.path.join(port_demo, "data.info"))
    want = _sorted_info(os.path.join(DATA_DIR, "data.info"))
    for col in ("transcript_id", "transcript_position", "n_reads"):
        assert (got[col] == want[col]).all(), col
    for g, w in zip(got.itertuples(), want.itertuples()):
        kmer_g, reads_g, feat_g = _read_site(os.path.join(port_demo, "data.json"), g.transcript_id,
                                             g.transcript_position, g.start, g.end)
        kmer_w, reads_w, feat_w = _read_site(os.path.join(DATA_DIR, "data.json"), w.transcript_id,
                                             w.transcript_position, w.start, w.end)
        assert kmer_g == kmer_w
        sg, sw = np.argsort(reads_g), np.argsort(reads_w)
        np.testing.assert_array_equal(reads_g[sg], reads_w[sw])
        np.testing.assert_allclose(feat_g[sg], feat_w[sw])
    assert is_successful(port_demo)


def _write_long_runs(path, n_reads=30, n_pos=40):
    """Reads with long runs of consecutive positions (the demo holds only
    3-position runs around each DRACH site, so it cannot exercise
    n_neighbors > 1): tests/test_dataprep.py's synthetic input."""
    import random

    rng = random.Random(0)
    seq = "".join(rng.choice("ACGT") for _ in range(n_pos + 10))
    for i in range(5, n_pos, 7):
        seq = seq[:i] + "GGACT" + seq[i + 5 :]
    with open(path, "w") as f:
        f.write(HEADER)
        for read in range(n_reads):
            for pos in range(n_pos):
                kmer = seq[pos : pos + 5]
                mean = 90 + (pos * 7 + read) % 40 + 0.25
                f.write(f"SYNTX.1\t{pos}\t{kmer}\t{read}\tt\t{pos}\t{mean}\t2.5\t0.004\t"
                        f"{kmer}\t100.0\t3.0\t0.5\t{pos * 10}\t{pos * 10 + 8}\n")


@pytest.mark.parametrize("case,flags", [
    ("json", dict(output_format="json")),
    ("columnar", dict(output_format="columnar")),
    ("both", dict(output_format="both")),
    ("compress", dict(output_format="both", compress=True)),
    ("n_neighbors_2", dict(output_format="both", n_neighbors=2)),
    ("host_shard_0", dict(output_format="both", host_shard=(0, 2))),
    ("host_shard_1", dict(output_format="both", host_shard=(1, 2))),
    ("readcount_gates", dict(output_format="both", readcount_min=3, readcount_max=5)),
    ("default_min_segment_count", dict(output_format="json", min_segment_count=20)),
])
def test_bytes_match_the_jax_dataprep(case, flags, jax_native, tmp_path):
    source = EVENTALIGN
    if case == "n_neighbors_2":
        source = str(tmp_path / "long_runs.txt")
        _write_long_runs(source)
    kwargs = {**GOLDEN_FLAGS, "n_processes": 2, **flags}
    jax_run_dataprep(source, str(tmp_path / "jax"), **kwargs)
    run_dataprep(source, str(tmp_path / "port"), **kwargs)
    _assert_same_bytes(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert os.path.getsize(tmp_path / "port" / "data.info") > 60  # sites, not only the header


def test_the_cli_gives_the_functions_bytes(port_demo, tmp_path):
    from m6anet_tpu_torch.cli import main

    main(["dataprep", "--eventalign", EVENTALIGN, "--out_dir", str(tmp_path), "--min_segment_count", "1",
          "--format", "both", "--n_processes", "2"])
    _assert_same_bytes(str(tmp_path), port_demo)


def test_parallel_matches_serial(port_demo, tmp_path, monkeypatch):
    """One worker with the native core threaded over reads, against the
    thread pool with the core single-threaded: the same bytes."""
    monkeypatch.setenv("M6A_NATIVE_THREADS", "4")
    run_dataprep(EVENTALIGN, str(tmp_path), n_processes=1, output_format="both", **GOLDEN_FLAGS)
    _assert_same_bytes(str(tmp_path), port_demo)


def test_gzip_input_matches_plain(port_demo, tmp_path):
    gz = tmp_path / "eventalign.txt.gz"
    with open(EVENTALIGN, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    run_dataprep(str(gz), str(tmp_path / "out"), n_processes=2, output_format="both", **GOLDEN_FLAGS)
    _assert_same_bytes(str(tmp_path / "out"), port_demo)


def _json_records(out_dir):
    info = pd.read_csv(os.path.join(out_dir, "data.info"))
    with open(os.path.join(out_dir, "data.json"), encoding="utf-8") as f:
        payloads = [json.loads(line) for line in f]
    return info[["transcript_id", "transcript_position", "n_reads"]], payloads


def test_numpy_path_matches_native_by_record(port_demo, tmp_path, monkeypatch):
    """Without the native library the port parses, aggregates and windows
    in numpy: the same sites, reads and values, the same index and columnar
    store; data.json renders its numbers otherwise, so its records are held
    equal, not its bytes."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    run_dataprep(EVENTALIGN, str(tmp_path), n_processes=2, output_format="both", **GOLDEN_FLAGS)
    info, payloads = _json_records(str(tmp_path))
    want_info, want_payloads = _json_records(port_demo)
    pd.testing.assert_frame_equal(info, want_info)
    assert payloads == want_payloads
    for name in _files(port_demo):
        if name not in ("data.json", "data.info"):
            assert filecmp.cmp(tmp_path / name, os.path.join(port_demo, name), shallow=False), name


def _adversarial_corpus(path, seed, n_reads=40):
    """Read slices of valid, malformed and hostile eventalign lines (the
    cases of tests/test_native_fuzz.py: short and long rows, k-mer
    mismatches, bad numerics in each numeric slot, exotic accepted numerics,
    CRLF endings, junk bytes); returns the slices and their byte ranges."""
    rng = np.random.default_rng(seed)
    kmers = [b"GGACT", b"AAACA", b"TGACC", b"CCCCC", b"AGACT"]
    bad_float = [b"", b"+5", b" 5", b"1_0", b"0x10", b"abc", b"1.2.3", b"5e", b".", b"1e999", b"1e-999"]
    good_float = [b"1.5", b".5", b"5.", b"2e3", b"-1.5E-2", b"nan", b"inf", b"-0.0", b"0e999"]
    bad_int = [b"", b"+7", b"3.0", b"9223372036854775808", b" 7", b"-"]

    def line(pos, kmer, mean, stdv, length, s13, s14, n_fields=15, mismatch=False, crlf=False):
        fields = [b"tx1", pos, kmer, b"0", b"t", b"12", mean, stdv, length, kmer + (b"X" if mismatch else b""),
                  b"103.2", b"2.1", b"0.0", s13, s14][:n_fields]
        fields += [b"extra"] * (n_fields - len(fields))
        return b"\t".join(fields) + (b"\r\n" if crlf else b"\n")

    slices = []
    for _ in range(n_reads):
        base, lines = int(rng.integers(0, 20)), []
        for _ in range(int(rng.integers(5, 60))):
            pos = str(base + int(rng.integers(0, 8))).encode()
            a = int(rng.integers(0, 10000))
            vals = dict(pos=pos, kmer=kmers[int(rng.integers(len(kmers)))],
                        mean=f"{rng.uniform(60, 140):.2f}".encode(), stdv=f"{rng.uniform(0.5, 5):.3f}".encode(),
                        length=f"{rng.uniform(0.001, 0.05):.5f}".encode(), s13=str(a).encode(),
                        s14=str(a + int(rng.integers(1, 30))).encode())
            kind = rng.random()
            if kind < 0.5:
                lines.append(line(**vals, crlf=bool(rng.random() < 0.2)))
            elif kind < 0.6:
                lines.append(line(**vals, mismatch=True))
            elif kind < 0.7:
                lines.append(line(**vals, n_fields=int(rng.integers(0, 20))))
            elif kind < 0.9:
                slot = ("pos", "mean", "stdv", "length", "s13", "s14")[int(rng.integers(6))]
                pool = bad_int if slot in ("pos", "s13", "s14") else bad_float
                lines.append(line(**{**vals, slot: pool[int(rng.integers(len(pool)))]}))
            elif kind < 0.97:
                lines.append(line(**{**vals, "mean": good_float[int(rng.integers(len(good_float)))],
                                     "stdv": good_float[int(rng.integers(len(good_float)))]}))
            else:
                junk = bytes(rng.integers(1, 255, size=int(rng.integers(0, 40))).astype(np.uint8))
                lines.append(junk.replace(b"\n", b"_") + b"\n")
        slices.append(b"".join(lines))
    path.write_bytes(b"".join(slices))
    bounds = np.cumsum([0] + [len(s) for s in slices]).astype(np.int64)
    return slices, bounds[:-1], bounds[1:]


def _same(a, b):
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_parsers_match_numpy_on_adversarial_input(seed, tmp_path):
    """ea_combine_batch against combine_read and ea_featurize_batch against
    combine_read + window_read, read by read: the same accept and reject
    decisions and the same bits."""
    path = tmp_path / "fuzz.txt"
    slices, starts, ends = _adversarial_corpus(path, seed)
    pos, kmers, feats, bounds = native.native_combine_batch(str(path), starts, ends)
    wpos, wseq, wfeat, wbounds, npos = native.native_featurize_batch(str(path), starts, ends, 1)
    kept = 0
    for r, blob in enumerate(slices):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        wlo, whi = int(wbounds[r]), int(wbounds[r + 1])
        combined = combine.combine_read(blob)
        if combined is None:
            assert hi - lo <= 1 and npos[r] <= 1 and whi == wlo, r
            continue
        kept += 1
        assert _same(pos[lo:hi], combined[0]) and _same(kmers[lo:hi], combined[1]) and _same(feats[lo:hi], combined[2])
        assert npos[r] == len(combined[0])
        windowed = windowing.window_read(combined, 1)
        if windowed is None:
            assert whi == wlo
            continue
        assert _same(wpos[wlo:whi], windowed[0]) and _same(wseq[wlo:whi], windowed[1])
        assert _same(wfeat[wlo:whi], windowed[2])
    assert kept > 10


def _fuzz_eventalign(path, seed=7):
    """tests/test_dataprep.py's randomized transcript: several events a
    position, gaps, duplicate read ids, failed alignments."""
    import random

    rng = random.Random(seed)
    seq = "".join(rng.choice("ACGT") for _ in range(60))
    for i in range(4, 50, 9):
        seq = seq[:i] + "AGACA" + seq[i + 5 :]
    with open(path, "w") as f:
        f.write(HEADER)
        for read in range(25):
            read_id, pos = read % 18, 0
            while pos < 50:
                if rng.random() < 0.15:
                    pos += rng.randint(1, 4)
                    continue
                kmer = seq[pos : pos + 5]
                model = kmer if rng.random() > 0.1 else "NNNNN"
                for _ in range(rng.randint(1, 3)):
                    s0 = rng.randint(0, 10**6)
                    f.write(f"FZTX.1\t{pos}\t{kmer}\t{read_id}\tt\t0\t{80 + rng.random() * 40:.3f}\t"
                            f"{1 + rng.random() * 5:.3f}\t{0.001 + rng.random() * 0.01:.5f}\t{model}\t0\t0\t0\t"
                            f"{s0}\t{s0 + rng.randint(3, 50)}\n")
                pos += 1


@pytest.mark.parametrize("n_neighbors", [1, 2])
def test_featurize_native_matches_numpy_on_the_fuzz_transcript(n_neighbors, tmp_path):
    path = tmp_path / "fuzz.txt"
    _fuzz_eventalign(path)
    indexer.build_index(str(path), str(tmp_path))
    _, _, read_idx, starts, ends = indexer.read_index_grouped(str(tmp_path / "eventalign.index"))
    slices = (read_idx, starts, ends)
    got = runner.featurize_transcript("FZTX.1", slices, n_neighbors, 1, False, eventalign_path=str(path))
    with open(path, "rb") as f:
        want = runner.featurize_transcript("FZTX.1", slices, n_neighbors, 1, False, eventalign_file=f)
    assert len(got) == len(want) > 0
    # a duplicated read id keeps its last slice in both paths, but the
    # numpy path's dict keeps the id's first place: hold reads sorted
    for (pn, sn, fn, rn, jn), (pp, sp, fp, rp, jp) in zip(got, want):
        assert pn == pp and sn == sp
        on, op = np.argsort(rn, kind="stable"), np.argsort(rp, kind="stable")
        np.testing.assert_array_equal(rn[on], rp[op])
        np.testing.assert_array_equal(fn[on], fp[op])
        rows_n, rows_p = (next(iter(json.loads(j)["FZTX.1"][str(pn)].values())) for j in (jn, jp))
        assert sorted(rows_n, key=lambda r: r[-1]) == sorted(rows_p, key=lambda r: r[-1])


def test_malformed_lines_are_skipped(jax_native, tmp_path):
    with open(EVENTALIGN) as f:
        lines = f.readlines()
    lines.insert(100, "ENST00000361055.8\tgarbage\n")
    lines.insert(200, "\n")
    bad = tmp_path / "bad.txt"
    bad.write_text("".join(lines))
    run_dataprep(str(bad), str(tmp_path / "port"), n_processes=1, **GOLDEN_FLAGS)
    jax_run_dataprep(str(bad), str(tmp_path / "jax"), n_processes=1, **GOLDEN_FLAGS)
    assert len(pd.read_csv(tmp_path / "port" / "data.info")) > 200
    _assert_same_bytes(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_interleaved_transcripts_keep_first_appearance_order(jax_native, tmp_path):
    """Reads of two transcripts interleaved in the file: every transcript's
    sites stay together, transcripts in order of first appearance, and the
    bytes are the JAX dataprep's."""
    with open(EVENTALIGN) as f:
        header, lines = f.readline(), f.readlines()
    blocks, key = [], None
    for ln in lines:
        k = (ln.split("\t")[0], ln.split("\t")[3])
        if k != key:
            blocks.append([])
            key = k
        blocks[-1].append(ln)
    path = tmp_path / "interleaved.txt"
    with open(path, "w") as out:
        out.write(header)
        for i, block in enumerate(blocks):
            out.writelines(("A" if i % 2 == 0 else "B") + ln for ln in block)
    run_dataprep(str(path), str(tmp_path / "port"), n_processes=2, **GOLDEN_FLAGS)
    jax_run_dataprep(str(path), str(tmp_path / "jax"), n_processes=2, **GOLDEN_FLAGS)
    _assert_same_bytes(str(tmp_path / "port"), str(tmp_path / "jax"))

    _, names, *_ = indexer.read_index_grouped(str(tmp_path / "port" / "eventalign.index"))
    seen = list(dict.fromkeys(("A" if i % 2 == 0 else "B") + block[0].split("\t")[0]
                              for i, block in enumerate(blocks)))
    assert names == seen
    info = pd.read_csv(tmp_path / "port" / "data.info")
    order = list(dict.fromkeys(info.transcript_id))
    assert info.transcript_id.tolist() == [t for t in order for _ in range((info.transcript_id == t).sum())]
    assert order == [t for t in seen if t in set(order)]


@pytest.mark.parametrize("output_format", ["json", "both"])
def test_header_only_input_gives_empty_outputs(output_format, tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text(HEADER)
    run_dataprep(str(path), str(tmp_path / "out"), n_processes=2, output_format=output_format, **GOLDEN_FLAGS)
    assert len(pd.read_csv(tmp_path / "out" / "data.info")) == 0
    assert os.path.getsize(tmp_path / "out" / "data.json") == 0
    assert is_successful(str(tmp_path / "out"))


def test_completion_trailer(tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text(HEADER)
    out = tmp_path / "out"
    run_dataprep(str(path), str(out), n_processes=1, **GOLDEN_FLAGS)
    assert is_successful(str(out))
    assert read_last_line(str(out / "data.log")) == runner.SUCCESS_TRAILER.encode()
    log = out / "data.log"
    log.write_bytes(log.read_bytes()[: -len(runner.SUCCESS_TRAILER)])  # a killed run
    assert not is_successful(str(out))
    with open(log, "ab") as f:
        f.write(b"ENST0000001: Data preparation ... Do")
    assert not is_successful(str(out))
    assert not is_successful(str(tmp_path / "nonexistent"))


def test_index_loader_takes_crlf_and_rejects_malformed_rows(tmp_path):
    src = os.path.join(DATA_DIR, "eventalign.index")
    crlf = tmp_path / "crlf.index"
    crlf.write_bytes(open(src, "rb").read().replace(b"\n", b"\r\n"))
    got, want = native.native_load_index(str(crlf)), native.native_load_index(src)
    assert got[4] == want[4]
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.index"
    bad.write_text("transcript_id,read_index,pos_start,pos_end\ntx,1,2x,3\n")
    assert native.native_load_index(str(bad)) is None
    # the pandas loader, where the library is missing, gives the same arrays
    codes, names, read_idx, starts, ends = indexer.read_index_grouped(src)
    tx_ids, read_p, starts_p, ends_p = indexer.read_index_arrays(src)
    assert [names[c] for c in codes] == list(tx_ids)
    for a, b in ((read_idx, read_p), (starts, starts_p), (ends, ends_p)):
        np.testing.assert_array_equal(a, b)


def test_native_library_builds_into_place_once(tmp_path):
    """The port's library comes from ops/_build.py (a private temporary
    file renamed into place under build/m6anet_tpu_torch/), never from an
    in-place g++ -o beside the source."""
    from m6anet_tpu_torch.ops import _build

    assert native.get_lib() is not None
    assert os.path.dirname(native.get_lib()._name) == _build.BUILD_DIR
    assert not any(name.endswith(".so") for name in os.listdir(os.path.dirname(native.__file__)))
