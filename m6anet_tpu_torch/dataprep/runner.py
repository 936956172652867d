"""Dataprep orchestration: eventalign.txt -> data.json / data.info / data.log.

Same file contracts as the reference
(reference: m6anet/utils/dataprep_utils.py:328-488) with a different
process architecture: the reference parses the whole file serially in the
main process and farms only the windowing to lock-synchronised consumers;
here workers are handed chunks of (transcript, byte-range list) tasks, do
their own seek+parse+combine+window, and the main process is a single
sequential writer (no file locks, deterministic offset bookkeeping).

The port's copy of the JAX package's ``dataprep/runner.py``: for the same
input and flags it writes the same bytes in every output file.

Output data.json lines are ``{"<tx>":{"<pos>":{"<7mer>":[[9 floats, read_id]...]}}}``
and data.info records the byte span of every line plus its read count, so the
reference's own readers (and ours) can seek straight to any site.
"""
from __future__ import annotations

import contextlib
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .combine import combine_read
from .indexer import build_index, open_eventalign, read_index_grouped
from .windowing import window_read

# One featurized site: (position, sequence context, features (n, 3*(2w+1))
# float64, read indices, pre-rendered data.json line (bytes) or None)
SiteRecord = Tuple[int, str, np.ndarray, np.ndarray, Optional[bytes]]
# A transcript's reads: (read indices, byte starts, byte ends), int64 arrays
ReadSlices = Tuple[np.ndarray, np.ndarray, np.ndarray]

# data.log completion sentinel — the exact trailer the reference's
# is_successful() looks for (reference: m6anet/utils/helper.py:103-104);
# unlike the reference, run_dataprep actually writes it on success.
SUCCESS_TRAILER = "--- SUCCESSFULLY FINISHED ---\n"

# Transcripts are grouped into chunks of about this many event bytes (or
# this many transcripts) so the native core is crossed once per chunk, not
# once per transcript: the ctypes round trip dominates on inputs of many
# small transcripts.
CHUNK_BYTES = 8 << 20
CHUNK_TX = 256

OUTPUT_FORMATS = ("json", "columnar", "both")


def read_last_line(filepath: str) -> Optional[bytes]:
    """Last line of a file without reading it all (None if missing/empty).

    Reference: m6anet/utils/helper.py:90-101."""
    if not os.path.exists(filepath):
        return None
    with open(filepath, "rb") as f:
        f.seek(0, os.SEEK_END)
        end = f.tell()
        if end == 0:
            return None
        step = 4096
        while True:
            start = max(0, end - step)
            f.seek(start)
            chunk = f.read(end - start)
            # ignore the file's trailing newline when splitting
            body = chunk[:-1] if chunk.endswith(b"\n") else chunk
            nl = body.rfind(b"\n")
            if nl != -1 or start == 0:
                return chunk[nl + 1 :] if nl != -1 else chunk
            step *= 4


def is_successful(out_dir: str) -> bool:
    """True if ``out_dir``'s data.log carries the completion sentinel, i.e.
    dataprep ran to the end rather than being killed mid-write."""
    return read_last_line(os.path.join(out_dir, "data.log")) == SUCCESS_TRAILER.encode()


def _records(site_pos, site_seq, site_nreads, feats, read_ids, json_lines, first: int, count: int,
             row: int) -> Tuple[List[SiteRecord], int]:
    """``count`` sites of a native result from site ``first``, whose reads
    start at row ``row``; returns the records and the next row."""
    records: List[SiteRecord] = []
    for i in range(first, first + count):
        n = int(site_nreads[i])
        records.append((
            int(site_pos[i]), site_seq[i].decode(), feats[row : row + n], read_ids[row : row + n],
            json_lines[i] if json_lines is not None else None,
        ))
        row += n
    return records, row


def featurize_transcript(
    tx_id: str,
    read_slices: ReadSlices,
    n_neighbors: int,
    min_segment_count: int,
    compress: bool,
    eventalign_file=None,
    emit_json: bool = True,
    eventalign_path: Optional[str] = None,
) -> List[SiteRecord]:
    """Featurize one transcript: read byte slices -> per-site records.

    ``read_slices`` is ``(read_indices, starts, ends)`` in eventalign.index
    order.  A duplicated read_index keeps only its last occurrence,
    matching the reference's dict overwrite
    (reference: m6anet/utils/dataprep_utils.py:385).

    With ``eventalign_path`` (plain text) and the native library, the whole
    transcript runs in native code; otherwise the numpy combiner reads the
    slices from the open ``eventalign_file``.
    """
    if eventalign_path is not None:
        from ..native import native_process_transcript

        processed = native_process_transcript(
            eventalign_path, tx_id, read_slices, n_neighbors, min_segment_count, compress, emit_json,
        )
        if processed is not None:
            return _records(*processed, first=0, count=len(processed[0]), row=0)[0]

    if eventalign_file is None:
        raise ValueError("no native library and no eventalign_file handle")
    per_read: Dict[int, Tuple] = {}
    for read_index, start, end in zip(*(a.tolist() for a in read_slices)):
        eventalign_file.seek(start)
        combined = combine_read(eventalign_file.read(end - start))
        if combined is not None:
            per_read[read_index] = combined

    all_pos: List[np.ndarray] = []
    all_seq: List[np.ndarray] = []
    all_feat: List[np.ndarray] = []
    all_read: List[np.ndarray] = []
    for read_index, combined in per_read.items():
        windowed = window_read(combined, n_neighbors)
        if windowed is None:
            continue
        pos, seq, feat = windowed
        all_pos.append(pos)
        all_seq.append(seq)
        all_feat.append(feat)
        all_read.append(np.full(len(pos), read_index, dtype=np.int64))
    if not all_pos:
        return []
    positions = np.concatenate(all_pos)
    seqs = np.concatenate(all_seq)
    feats = np.concatenate(all_feat)
    read_ids = np.concatenate(all_read)

    # Stable sort by position keeps reads in file order within a site
    # (reference: m6anet/utils/dataprep_utils.py:444-450).
    order = np.argsort(positions, kind="stable")
    positions, seqs, feats, read_ids = positions[order], seqs[order], feats[order], read_ids[order]
    uniq_pos, starts = np.unique(positions, return_index=True)
    bounds = np.concatenate([starts[1:], [len(positions)]])

    records: List[SiteRecord] = []
    for pos, s, e in zip(uniq_pos, starts, bounds):
        seq = seqs[s]
        # The reference additionally skips all-XXXXX placeholder motifs
        # (reference: m6anet/utils/dataprep_utils.py:465-467); unreachable
        # here because the DRACH center filter already excludes them.
        if e - s < min_segment_count:
            continue
        feat = feats[s:e]
        if compress:
            feat = feat.round(decimals=3)
        line = None
        if emit_json:
            rows = np.concatenate([feat, read_ids[s:e, None].astype(np.float64)], axis=1)
            payload = {seq.decode(): rows.tolist()}
            line = (
                '{"%s":{"%d":%s}}\n' % (tx_id, int(pos), json.dumps(payload, separators=(",", ":")))
            ).encode()
        records.append((int(pos), seq.decode(), feat, read_ids[s:e], line))
    return records


def featurize_transcript_chunk(
    eventalign_path: str,
    names: List[str],
    slices: List[ReadSlices],
    n_neighbors: int,
    min_segment_count: int,
    compress: bool,
    emit_json: bool,
) -> Optional[List[Tuple[str, List[SiteRecord]]]]:
    """Featurize many transcripts with one native call.

    Returns [(tx_id, [SiteRecord, ...]), ...] in input order, or None when
    the native path is unavailable (the caller falls back per transcript).
    """
    from ..native import native_process_transcripts

    bounds = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(s[0]) for s in slices], out=bounds[1:])
    read_idx, starts, ends = (np.concatenate([s[k] for s in slices]) for k in range(3))
    out = native_process_transcripts(
        eventalign_path, names, bounds, read_idx, starts, ends,
        n_neighbors, min_segment_count, compress, emit_json,
    )
    if out is None:
        return None
    tx_counts, *sites = out
    results = []
    first = row = 0
    for name, count in zip(names, tx_counts.tolist()):
        records, row = _records(*sites, first=first, count=count, row=row)
        results.append((name, records))
        first += count
    return results


def iter_transcript_tasks(codes, names, read_idx, starts, ends) -> Iterator[Tuple[str, ReadSlices]]:
    """Yields (tx_id, (read_idx, starts, ends)) per transcript in
    first-appearance order (codes are first-appearance factorized, see
    indexer.read_index_grouped), the reference's dict.setdefault grouping
    (reference: m6anet/utils/dataprep_utils.py:370-379)."""
    order = np.argsort(codes, kind="stable")
    bounds = np.flatnonzero(np.diff(codes[order])) + 1
    group_starts = np.concatenate([[0], bounds])
    group_ends = np.concatenate([bounds, [len(codes)]])
    for g in range(len(names)):
        idx = order[group_starts[g] : group_ends[g]]
        yield names[g], (
            np.ascontiguousarray(read_idx[idx]),
            np.ascontiguousarray(starts[idx]),
            np.ascontiguousarray(ends[idx]),
        )


def run_dataprep(eventalign_path: str, out_dir: str, **kwargs) -> None:
    """Full dataprep (see :func:`_run_dataprep` for the options).

    A gzipped input is decompressed once to a scratch file in ``out_dir``
    so the native parsing core (which needs seekable plain bytes) applies —
    the index's byte offsets refer to the decompressed stream either way,
    and per-read gzip seeks would otherwise re-inflate from the start of
    the member each time."""
    if not eventalign_path.endswith(".gz"):
        _run_dataprep(eventalign_path, out_dir, **kwargs)
        return
    import gzip
    import shutil
    import tempfile

    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".eventalign.txt", dir=out_dir)
    try:
        with gzip.open(eventalign_path, "rb") as src, os.fdopen(fd, "wb") as dst:
            shutil.copyfileobj(src, dst, 8 << 20)
        _run_dataprep(tmp, out_dir, **kwargs)
    finally:
        os.remove(tmp)


def _run_dataprep(
    eventalign_path: str,
    out_dir: str,
    n_processes: int = 1,
    chunk_size: int = 1_000_000,
    readcount_min: int = 1,
    readcount_max: int = 1000,
    min_segment_count: int = 20,
    n_neighbors: int = 1,
    compress: bool = False,
    skip_index: bool = False,
    output_format: str = "json",
    host_shard: Optional[Tuple[int, int]] = None,
) -> None:
    """Full dataprep: index (stage A) + featurize/write (stage B).

    ``chunk_size`` is accepted for CLI compatibility but unused — the
    streaming indexer has no chunking knob.  ``output_format`` is one of
    'json' (reference-compatible data.json), 'columnar' (memory-mappable
    store, see ``data/columnar.py``), or 'both'.  data.info is always
    written; in columnar-only mode its start/end byte offsets are zero.

    ``host_shard=(host_id, n_hosts)`` featurizes only this host's contiguous
    slice of the transcript list (every host runs over the same eventalign
    and index but writes its own out_dir; the shard directories are read
    together by inference --concat_shards).
    """
    del chunk_size
    if output_format not in OUTPUT_FORMATS:
        raise ValueError(f"invalid output_format {output_format!r}")
    emit_json = output_format in ("json", "both")
    os.makedirs(out_dir, exist_ok=True)
    index_path = os.path.join(out_dir, "eventalign.index")
    if not skip_index or not os.path.exists(index_path):
        build_index(eventalign_path, out_dir)
    idx_codes, idx_names, idx_read, idx_start, idx_end = read_index_grouped(index_path)

    tx_filter = None
    if host_shard is not None:
        host_id, n_hosts = host_shard
        per = -(-len(idx_names) // n_hosts)  # names: first-appearance order, unique
        tx_filter = set(idx_names[host_id * per : (host_id + 1) * per])

    def chunks() -> Iterator[Tuple[List[str], List[ReadSlices]]]:
        names: List[str] = []
        slices: List[ReadSlices] = []
        total = 0
        for tx_id, tx_slices in iter_transcript_tasks(idx_codes, idx_names, idx_read, idx_start, idx_end):
            if tx_filter is not None and tx_id not in tx_filter:
                continue
            # readcount gates count *attempted* reads, capped by the break at
            # readcount_max (whose post-increment placement admits
            # readcount_max + 1 of them) — so a transcript with more reads
            # than the cap still only counts the cap toward readcount_min
            # (reference: m6anet/utils/dataprep_utils.py:379-390).
            if min(len(tx_slices[0]), readcount_max + 1) < readcount_min:
                continue
            capped = tuple(a[: readcount_max + 1] for a in tx_slices)
            names.append(tx_id)
            slices.append(capped)
            total += int((capped[2] - capped[1]).sum())
            if total >= CHUNK_BYTES or len(names) >= CHUNK_TX:
                yield names, slices
                names, slices, total = [], [], 0
        if names:
            yield names, slices

    def run_chunk(chunk) -> List[Tuple[str, List[SiteRecord]]]:
        names, slices = chunk
        out = featurize_transcript_chunk(
            eventalign_path, names, slices, n_neighbors, min_segment_count, compress, emit_json,
        )
        if out is None:  # no native library: the numpy path, per transcript
            with open_eventalign(eventalign_path, buffering=1024 * 1024) as ev:
                out = [
                    (name, featurize_transcript(name, tx_slices, n_neighbors, min_segment_count, compress,
                                                eventalign_file=ev, emit_json=emit_json))
                    for name, tx_slices in zip(names, slices)
                ]
        return out

    columnar_writer = None
    if output_format in ("columnar", "both"):
        from ..data.columnar import ColumnarWriter

        columnar_writer = ColumnarWriter(out_dir, 2 * n_neighbors + 1)

    # data.json is written in binary with a manually tracked offset:
    # TextIOWrapper.tell() is slow per call, and the lines are pre-rendered
    # bytes whose lengths are the offsets (same contract as the reference's
    # f.tell() bookkeeping, reference: m6anet/utils/dataprep_utils.py:476-485).
    json_offset = 0
    json_cm = open(os.path.join(out_dir, "data.json"), "wb") if emit_json else contextlib.nullcontext()
    with json_cm as f_json, open(os.path.join(out_dir, "data.info"), "w", encoding="utf-8") as f_info, open(
        os.path.join(out_dir, "data.log"), "w", encoding="utf-8"
    ) as f_log:
        f_info.write("transcript_id,transcript_position,start,end,n_reads\n")

        def write_result(tx_id: str, records: List[SiteRecord]) -> None:
            nonlocal json_offset
            info_rows, json_parts = [], []
            for pos, seq, feat, read_ids, line in records:
                start = end = 0
                if emit_json:
                    start = json_offset
                    json_parts.append(line)
                    json_offset += len(line)
                    end = json_offset
                if columnar_writer is not None:
                    columnar_writer.append_site(tx_id, pos, seq, feat, read_ids)
                info_rows.append(f"{tx_id},{pos},{start},{end},{len(read_ids)}\n")
            if json_parts:
                f_json.write(b"".join(json_parts))
            f_info.write("".join(info_rows))
            f_log.write(f"{tx_id}: Data preparation ... Done.\n")

        if n_processes <= 1:
            for chunk in chunks():
                for tx_id, records in run_chunk(chunk):
                    write_result(tx_id, records)
        else:
            # Thread workers, not processes: the native core does the heavy
            # parsing with the GIL released, so threads scale like processes
            # here — without fork/spawn hazards or result pickling.  Ordered
            # completion keeps the writer simple.  The pool provides the
            # parallelism, so the native core is kept single-threaded per
            # call (no oversubscription); its output does not depend on it.
            os.environ.setdefault("M6A_NATIVE_THREADS", "1")
            with ThreadPoolExecutor(max_workers=n_processes) as pool:
                pending: deque = deque()
                for chunk in chunks():
                    pending.append(pool.submit(run_chunk, chunk))
                    while len(pending) >= n_processes * 4:
                        for tx_id, records in pending.popleft().result():
                            write_result(tx_id, records)
                while pending:
                    for tx_id, records in pending.popleft().result():
                        write_result(tx_id, records)

        # completion sentinel: the reference defines is_successful()/
        # read_last_line() against this exact trailer but nothing there ever
        # writes it (reference: m6anet/utils/helper.py:90-104); here a
        # successful run really ends data.log with it, so downstream tooling
        # can tell a finished dataprep from a killed one.
        f_log.write(SUCCESS_TRAILER)

    if columnar_writer is not None:
        columnar_writer.finalize()
