"""ctypes bindings for the native host helpers of the inference path.

The shared library is compiled from ``eventalign_parser.cpp`` on first use
(g++ -O3, ~1 s) into the port's build directory (see ``ops/_build.py``).
Every entry point returns None when the library is unavailable, and its
caller falls back to a pure-Python path — slower, same output.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

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
