"""ctypes bindings for the native eventalign parsing core and the host
helpers of the inference path.

The shared library is compiled from ``eventalign_parser.cpp`` on first use
(g++ -O3, ~1 s) into the port's build directory (see ``ops/_build.py``:
a private temporary file renamed into place, so processes and threads that
build at once never load a half-written library).  Every entry point
returns None (``native_index``: False) when the library is unavailable or
the input is gzipped, and its caller falls back to a pure-Python path —
slower, same records.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..ops._build import GXX_FLAGS, BuildError, build_shared_libraries

_SRC = os.path.join(os.path.dirname(__file__), "eventalign_parser.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_scratch = threading.local()  # per-thread reusable output buffers


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        try:
            (path,) = build_shared_libraries([(_SRC, ["g++", *GXX_FLAGS])])
            lib = ctypes.CDLL(path)
        except (BuildError, OSError):
            _build_failed = True
            return None
        _declare_dataprep(lib)
        lib.ea_parse_site_json.restype = ctypes.c_longlong
        lib.ea_parse_site_json.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.ea_render_indiv_csv_batch.restype = ctypes.c_longlong
        lib.ea_render_indiv_csv_batch.argtypes = (
            [ctypes.c_char_p] + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
        )
        _lib = lib
        return _lib


def native_parse_site_json(raw: bytes, n_cols: int):
    """Parse one data.json site line natively.

    Returns (kmer str, features (rows, n_cols) float64) or None when the
    native library is unavailable (caller falls back to json.loads).
    """
    lib = get_lib()
    if lib is None:
        return None
    # rows are >= ~10 bytes each; generous cap
    cap_rows = len(raw) // (2 * n_cols) + 4
    out = np.empty((cap_rows, n_cols), np.float64)
    kmer_buf = ctypes.create_string_buffer(32)
    rows = lib.ea_parse_site_json(raw, len(raw), out, cap_rows, n_cols, kmer_buf, 32)
    if rows < 0:
        return None
    return kmer_buf.value.decode(), out[: int(rows)].copy()


def native_render_indiv_csv_batch(
    prefixes: bytes,
    prefix_off: np.ndarray,
    site_counts: np.ndarray,
    read_ids: np.ndarray,
    probs: np.ndarray,
):
    """Render a whole batch of sites' indiv-probability CSV rows in one call.

    ``prefixes``/``prefix_off`` hold each site's "tx,pos," prefix
    (concatenated bytes + n_sites+1 int64 offsets); ``site_counts`` the reads
    per site; ``read_ids``/``probs`` the flat per-read arrays.  Returns bytes
    or None when unavailable.
    """
    if read_ids.dtype != np.int64:
        return None
    lib = get_lib()
    if lib is None:
        return None
    prefix_off = np.ascontiguousarray(prefix_off, dtype=np.int64)
    site_counts = np.ascontiguousarray(site_counts, dtype=np.int64)
    read_ids = np.ascontiguousarray(read_ids)
    probs = np.ascontiguousarray(probs, dtype=np.float32)
    n_sites = len(site_counts)
    max_prefix = int(np.diff(prefix_off).max()) if n_sites else 0
    cap = (max_prefix + 64) * len(read_ids) + 16

    buf = getattr(_scratch, "csv_buf", None)
    if buf is None or len(buf) < cap:
        buf = np.empty(max(cap, 1 << 20), np.uint8)
        _scratch.csv_buf = buf
    written = lib.ea_render_indiv_csv_batch(
        prefixes, prefix_off.ctypes.data, site_counts.ctypes.data, n_sites,
        read_ids.ctypes.data, probs.ctypes.data, buf.ctypes.data, len(buf),
    )
    if written < 0:
        return None
    return buf[: int(written)].tobytes()


# ---------------------------------------------------------------------------
# dataprep entry points
# ---------------------------------------------------------------------------

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_PTR = ctypes.c_void_p
_I64V = ctypes.c_int64


def _declare_dataprep(lib: ctypes.CDLL) -> None:
    """Signatures of the dataprep entry points.  The per-transcript calls
    take raw pointers (``array.ctypes.data``): they run once per transcript
    or chunk, and ndpointer's per-argument checks dominate on inputs of
    many small transcripts; every array passed to them is allocated here,
    C-contiguous, of the dtype the C side expects."""
    lib.ea_index.restype = ctypes.c_longlong
    lib.ea_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ea_combine_batch.restype = ctypes.c_longlong
    lib.ea_combine_batch.argtypes = [ctypes.c_char_p, _I64, _I64, _I64V, _I64, _U8, _F64, _I64, _I64V]
    lib.ea_featurize_batch.restype = ctypes.c_longlong
    lib.ea_featurize_batch.argtypes = [
        ctypes.c_char_p, _I64, _I64, _I64V, _U8, _I64V, _I64V, _I64, _U8, _F64, _I64, _I64, _I64V,
    ]
    lib.ea_process_transcript.restype = ctypes.c_longlong
    lib.ea_process_transcript.argtypes = (
        [ctypes.c_char_p, ctypes.c_char_p] + [_PTR] * 3
        + [_I64V, _PTR, _I64V, _I64V, _I64V, ctypes.c_int32, ctypes.c_int32]
        + [_PTR] * 5 + [_PTR, _I64V, _PTR, _I64V, _I64V]
    )
    lib.ea_process_transcripts.restype = ctypes.c_longlong
    lib.ea_process_transcripts.argtypes = (
        [ctypes.c_char_p] + [_PTR] * 6 + [_I64V]
        + [_PTR, _I64V, _I64V, _I64V, ctypes.c_int32, ctypes.c_int32]
        + [_PTR] * 6 + [_I64V, _PTR, _I64V, _I64V]
    )
    lib.ea_load_index.restype = ctypes.c_longlong
    lib.ea_load_index.argtypes = [ctypes.c_char_p] + [_PTR] * 4 + [_I64V, _PTR, _I64V, _PTR]


def _plain_lib(eventalign_path: str) -> Optional[ctypes.CDLL]:
    """The library, or None for gzipped input (the native parsers seek in
    plain bytes) and where the library is unavailable."""
    if eventalign_path.endswith(".gz"):
        return None
    return get_lib()


_MOTIF_BUF: Optional[np.ndarray] = None


def _motif_buffer() -> np.ndarray:
    """The DRACH 5-mers, concatenated, as the C side reads them."""
    global _MOTIF_BUF
    if _MOTIF_BUF is None:
        from ..constants import M6A_KMERS

        _MOTIF_BUF = np.frombuffer("".join(M6A_KMERS).encode(), dtype=np.uint8).copy()
    return _MOTIF_BUF


def _window_cap(starts: np.ndarray, ends: np.ndarray) -> int:
    # the shortest well-formed eventalign line is over 30 bytes
    return int((ends - starts).sum() // 30 + len(starts) + 16)


def _split_lines(buf: np.ndarray, lens: np.ndarray) -> List[bytes]:
    raw = buf[: int(lens.sum())].tobytes()
    out, off = [], 0
    for ln in lens.tolist():
        out.append(raw[off : off + ln])
        off += ln
    return out


def native_index(eventalign_path: str, out_path: str) -> bool:
    """Native byte-range indexer; False => the caller uses the Python scan
    (no library, or gzipped input)."""
    lib = _plain_lib(eventalign_path)
    if lib is None:
        return False
    return lib.ea_index(eventalign_path.encode(), out_path.encode()) >= 0


def native_combine_batch(
    eventalign_path: str, starts: np.ndarray, ends: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Parse + aggregate a transcript's read byte slices natively.

    Returns (positions, kmers (S5), features (n, 3), read_bounds
    (n_reads + 1)) or None when the native path is unavailable."""
    lib = _plain_lib(eventalign_path)
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    n = len(starts)
    cap = _window_cap(starts, ends)
    out_pos = np.empty(cap, np.int64)
    out_kmer = np.empty(cap * 5, np.uint8)
    out_feat = np.empty(cap * 3, np.float64)
    out_bounds = np.empty(n + 1, np.int64)
    total = lib.ea_combine_batch(
        eventalign_path.encode(), starts, ends, n, out_pos, out_kmer, out_feat, out_bounds, cap
    )
    if total < 0:
        return None
    return (
        out_pos[:total].copy(),
        out_kmer[: total * 5].view("S5").copy(),
        out_feat[: total * 3].reshape(-1, 3).copy(),
        out_bounds,
    )


def native_featurize_batch(
    eventalign_path: str, starts: np.ndarray, ends: np.ndarray, window_size: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Fused parse + aggregate + window + DRACH filter of a transcript's
    reads.

    Returns (centre positions, sequence contexts S(5+2w), window features
    (n, 3(2w+1)), window bounds per read (n_reads + 1), aggregated
    positions per read (n_reads,)) or None when unavailable."""
    lib = _plain_lib(eventalign_path)
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    n = len(starts)
    motifs = _motif_buffer()
    seq_len = 5 + 2 * window_size
    width = 2 * window_size + 1
    cap = _window_cap(starts, ends)
    out_pos = np.empty(cap, np.int64)
    out_seq = np.empty(cap * seq_len, np.uint8)
    out_feat = np.empty(cap * 3 * width, np.float64)
    out_bounds = np.empty(n + 1, np.int64)
    out_npos = np.empty(n, np.int64)
    total = lib.ea_featurize_batch(
        eventalign_path.encode(), starts, ends, n, motifs, len(motifs) // 5,
        window_size, out_pos, out_seq, out_feat, out_bounds, out_npos, cap,
    )
    if total < 0:
        return None
    return (
        out_pos[:total].copy(),
        out_seq[: total * seq_len].view(f"S{seq_len}").copy(),
        out_feat[: total * 3 * width].reshape(-1, 3 * width).copy(),
        out_bounds,
        out_npos,
    )


def _grown(key: str, need: dict, seq_len: int) -> dict:
    """This thread's reusable output buffers for ``key``, grown to ``need``
    (outputs are copied before return, so the buffers serve the thread's
    next call).  ``json_buf`` alone is ~100 MB per worker at an 8 MB chunk,
    so a buffer far larger than the current need is released."""
    sc = getattr(_scratch, key, None)
    if sc is not None and sc["json_cap"] > (256 << 20) and need["json_cap"] < sc["json_cap"] // 4:
        sc = None
    if sc is None or sc["seq_len"] != seq_len or any(sc[k] < v for k, v in need.items()):
        caps = {k: max(v, 0 if sc is None else sc[k]) for k, v in need.items()}
        w, s, j = caps["cap_windows"], caps["cap_sites"], caps["json_cap"]
        nfeat = 3 * (seq_len - 4)
        sc = {
            **caps,
            "seq_len": seq_len,
            "site_pos": np.empty(s, np.int64),
            "site_seq": np.empty(s * seq_len, np.uint8),
            "site_nreads": np.empty(s, np.int64),
            "feat_out": np.empty(w * nfeat, np.float64),
            "read_out": np.empty(w, np.int64),
            "json_buf": np.empty(j, np.uint8),
            "json_len": np.empty(s, np.int64),
        }
        setattr(_scratch, key, sc)
    return sc


def _json_cap(cap_windows: int, cap_sites: int, seq_len: int, emit_json: bool) -> int:
    nfeat = 3 * (seq_len - 4)
    return (cap_windows * 26 * (nfeat + 1) + cap_sites * (seq_len + 64)) if emit_json else 1


def _site_outputs(sc: dict, n_sites: int, emit_json: bool):
    """(site_pos, site_seq, site_nreads, features, read_ids, json_lines)
    of the first ``n_sites`` sites in ``sc``, copied out."""
    seq_len = sc["seq_len"]
    nfeat = 3 * (seq_len - 4)
    site_nreads = sc["site_nreads"][:n_sites].copy()
    rows = int(site_nreads.sum())
    return (
        sc["site_pos"][:n_sites].copy(),
        sc["site_seq"][: n_sites * seq_len].view(f"S{seq_len}").copy(),
        site_nreads,
        sc["feat_out"][: rows * nfeat].reshape(-1, nfeat).copy(),
        sc["read_out"][:rows].copy(),
        _split_lines(sc["json_buf"], sc["json_len"][:n_sites]) if emit_json else None,
    )


def native_process_transcript(
    eventalign_path: str,
    tx_id: str,
    read_slices: Tuple[np.ndarray, np.ndarray, np.ndarray],
    window_size: int,
    min_segment_count: int,
    compress: bool,
    emit_json: bool,
):
    """Whole-transcript featurization in native code.

    ``read_slices`` is ``(read_indices, starts, ends)``.  Returns
    (site_pos, site_seq (S(5+2w)), site_nreads, features (n, 3(2w+1))
    float64 in site-major read order, read_ids (n,), json_lines
    list[bytes] or None) — or None when the native path is unavailable."""
    lib = _plain_lib(eventalign_path)
    if lib is None:
        return None
    read_idx, starts, ends = (np.ascontiguousarray(a, dtype=np.int64) for a in read_slices)
    motifs = _motif_buffer()
    seq_len = 5 + 2 * window_size
    cap_windows = _window_cap(starts, ends)
    cap_sites = cap_windows + 1
    sc = _grown("one", {"cap_windows": cap_windows, "cap_sites": cap_sites,
                        "json_cap": _json_cap(cap_windows, cap_sites, seq_len, emit_json)}, seq_len)
    n_sites = lib.ea_process_transcript(
        eventalign_path.encode(), tx_id.encode(),
        starts.ctypes.data, ends.ctypes.data, read_idx.ctypes.data, len(starts),
        motifs.ctypes.data, len(motifs) // 5, window_size, min_segment_count,
        1 if compress else 0, 1 if emit_json else 0,
        sc["site_pos"].ctypes.data, sc["site_seq"].ctypes.data, sc["site_nreads"].ctypes.data,
        sc["feat_out"].ctypes.data, sc["read_out"].ctypes.data,
        sc["json_buf"].ctypes.data, sc["json_cap"], sc["json_len"].ctypes.data,
        sc["cap_sites"], sc["cap_windows"],
    )
    if n_sites < 0:
        return None
    return _site_outputs(sc, int(n_sites), emit_json)


def native_process_transcripts(
    eventalign_path: str,
    tx_names: List[str],
    tx_bounds: np.ndarray,
    read_idx: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    window_size: int,
    min_segment_count: int,
    compress: bool,
    emit_json: bool,
):
    """Many transcripts in one native call (the per-call crossing dominates
    on inputs of many small transcripts).  ``tx_bounds`` (n_tx + 1) cuts
    the read arrays into transcripts.

    Returns (tx_site_counts int64[n_tx], site_pos, site_seq S(5+2w),
    site_nreads, features (rows, 3(2w+1)) float64, read_ids, json_lines
    list[bytes] or None), concatenated in transcript order — or None when
    the native path is unavailable."""
    lib = _plain_lib(eventalign_path)
    if lib is None:
        return None
    tx_bounds, read_idx, starts, ends = (
        np.ascontiguousarray(a, dtype=np.int64) for a in (tx_bounds, read_idx, starts, ends)
    )
    n_tx = len(tx_names)
    names_blob = "".join(tx_names).encode()
    name_off = np.zeros(n_tx + 1, np.int64)
    np.cumsum([len(n.encode()) for n in tx_names], out=name_off[1:])
    motifs = _motif_buffer()
    seq_len = 5 + 2 * window_size
    cap_windows = int((ends - starts).sum() // 30) + len(starts) + 16 * n_tx
    cap_sites = cap_windows + n_tx
    sc = _grown("batch", {"cap_windows": cap_windows, "cap_sites": cap_sites,
                          "json_cap": _json_cap(cap_windows, cap_sites, seq_len, emit_json)}, seq_len)
    tx_site_counts = np.zeros(n_tx, np.int64)
    n_sites = lib.ea_process_transcripts(
        eventalign_path.encode(), names_blob, name_off.ctypes.data,
        tx_bounds.ctypes.data, starts.ctypes.data, ends.ctypes.data,
        read_idx.ctypes.data, n_tx,
        motifs.ctypes.data, len(motifs) // 5, window_size, min_segment_count,
        1 if compress else 0, 1 if emit_json else 0,
        tx_site_counts.ctypes.data, sc["site_pos"].ctypes.data,
        sc["site_seq"].ctypes.data, sc["site_nreads"].ctypes.data,
        sc["feat_out"].ctypes.data, sc["read_out"].ctypes.data,
        sc["json_buf"].ctypes.data, sc["json_cap"], sc["json_len"].ctypes.data,
        sc["cap_sites"], sc["cap_windows"],
    )
    if n_sites < 0:
        return None
    return (tx_site_counts, *_site_outputs(sc, int(n_sites), emit_json))


def native_load_index(index_path: str):
    """Parse eventalign.index natively in one pass, transcript ids
    factorized to first-appearance codes (no per-row Python strings).

    Returns (codes int32, read_idx int64, pos_start int64, pos_end int64,
    names list[str]) or None when unavailable or the file is malformed."""
    lib = get_lib()
    if lib is None:
        return None
    fsize = os.path.getsize(index_path)
    # sized by an upper bound (the shortest row is 8 bytes); exact copies
    # are returned, so the large buffers go at once
    cap_rows = fsize // 8 + 2
    codes = np.empty(cap_rows, np.int32)
    read_idx = np.empty(cap_rows, np.int64)
    pos_start = np.empty(cap_rows, np.int64)
    pos_end = np.empty(cap_rows, np.int64)
    name_buf = np.empty(fsize + 1, np.uint8)
    meta = np.zeros(2, np.int64)  # [n_uniq, name_bytes]
    rows = lib.ea_load_index(
        index_path.encode(), codes.ctypes.data, read_idx.ctypes.data,
        pos_start.ctypes.data, pos_end.ctypes.data, cap_rows,
        name_buf.ctypes.data, len(name_buf), meta.ctypes.data,
    )
    if rows < 0:
        return None
    rows = int(rows)
    names = name_buf[: int(meta[1])].tobytes().decode().split("\n")[: int(meta[0])]
    return codes[:rows].copy(), read_idx[:rows].copy(), pos_start[:rows].copy(), pos_end[:rows].copy(), names
