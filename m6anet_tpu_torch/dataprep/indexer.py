"""Stage A: byte-range indexing of nanopolish/f5c eventalign.txt.

Produces ``eventalign.index`` (CSV: transcript_id,read_index,pos_start,pos_end)
with the same contract as the reference
(reference: m6anet/utils/dataprep_utils.py:187-266), but via a single
streaming binary scan that tracks (contig, read_index) transitions instead of
chunked pandas frames + per-line ``readline()`` length accounting.  The scan
is sequential-I/O bound and needs no worker pool.

A gzipped input (``*.gz``) is accepted transparently; byte offsets then refer
to the *decompressed* stream, matching how the reader re-opens it.
"""
from __future__ import annotations

import gzip
import os
from typing import Iterator, Tuple

import numpy as np

# (transcript_id, read_index, pos_start, pos_end)
IndexRow = Tuple[str, int, int, int]

_CHUNK = 32 * 1024 * 1024


def open_eventalign(path: str, buffering: int = 8 * 1024 * 1024):
    """Open eventalign.txt (optionally gzipped) in binary mode
    (gzip support parity: reference m6anet/utils/helper.py:8-39)."""
    if os.path.splitext(path)[1] == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=buffering)


def iter_index_rows(path: str) -> Iterator[IndexRow]:
    """Stream (contig, read_index) byte ranges from an eventalign file.

    The header line is excluded from all ranges.  Each yielded range covers
    the maximal run of consecutive lines sharing (contig, read_index) —
    eventalign emits each read's events contiguously, which is the same
    assumption the reference's chunk-groupby makes.
    """
    with open_eventalign(path) as f:
        header = f.readline()
        pos = len(header)
        cur_key = None
        cur_start = pos
        leftover = b""
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            block = leftover + block
            lines = block.split(b"\n")
            leftover = lines.pop()  # partial last line (or b"")
            for line in lines:
                nbytes = len(line) + 1
                # contig = field 0, read_index = field 3
                tab1 = line.find(b"\t")
                contig = line[:tab1]
                rest = line[tab1 + 1 :]
                t2 = rest.find(b"\t")
                t3 = rest.find(b"\t", t2 + 1)
                t4 = rest.find(b"\t", t3 + 1)
                read_index = rest[t3 + 1 : t4]
                key = (contig, read_index)
                if key != cur_key:
                    if cur_key is not None:
                        yield (
                            cur_key[0].decode(),
                            int(cur_key[1]),
                            cur_start,
                            pos,
                        )
                    cur_key = key
                    cur_start = pos
                pos += nbytes
        if leftover:
            raise ValueError("eventalign file does not end with a newline")
        if cur_key is not None:
            yield cur_key[0].decode(), int(cur_key[1]), cur_start, pos


def build_index(eventalign_path: str, out_dir: str) -> str:
    """Write eventalign.index; returns its path.

    Uses the native C++ scanner when available (``native/``), falling
    back to the Python streaming scan (always used for gzipped input)."""
    out_path = os.path.join(out_dir, "eventalign.index")
    from ..native import native_index

    if native_index(eventalign_path, out_path):
        return out_path
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("transcript_id,read_index,pos_start,pos_end\n")
        for tx_id, read_index, start, end in iter_index_rows(eventalign_path):
            f.write(f"{tx_id},{read_index},{start},{end}\n")
    return out_path


def read_index_arrays(index_path: str):
    """Columnar eventalign.index load: (tx_ids object[], read_index int64[],
    pos_start int64[], pos_end int64[]) in file order.

    transcript_id is read as dtype=object: newer pandas otherwise routes
    string columns through Arrow conversion, which dominates this read on
    large indexes."""
    import pandas as pd

    df = pd.read_csv(
        index_path,
        dtype={"transcript_id": object, "read_index": np.int64, "pos_start": np.int64, "pos_end": np.int64},
        engine="c",
    )
    return (
        df["transcript_id"].to_numpy(),
        df["read_index"].to_numpy(),
        df["pos_start"].to_numpy(),
        df["pos_end"].to_numpy(),
    )


def read_index_grouped(index_path: str):
    """Factorized eventalign.index load: (codes int32[], names list[str],
    read_index int64[], pos_start int64[], pos_end int64[]) with codes in
    first-appearance order — no per-row Python strings.

    Native single-pass parser when available; pandas + factorize fallback."""
    from ..native import native_load_index

    native = native_load_index(index_path)
    if native is not None:
        codes, read_idx, starts, ends, names = native
        return codes, names, read_idx, starts, ends

    import pandas as pd

    tx_ids, read_idx, starts, ends = read_index_arrays(index_path)
    codes, uniques = pd.factorize(tx_ids)
    return codes.astype(np.int32), [str(u) for u in uniques], read_idx, starts, ends
