"""Per-read event aggregation: eventalign lines -> one feature row per position.

Behavior parity with the reference combiner
(reference: m6anet/utils/dataprep_utils.py:269-325): keep only successfully
aligned events (``reference_kmer == model_kmer``), aggregate events per
transcript position with sample-length weights, round the mean current to one
decimal, and shift positions by +2 to the 5-mer center — but implemented as a
direct bytes->numpy reducer (no pandas DataFrame per read slice).  The
port's copy of the JAX package's ``dataprep/combine.py``; it is the fallback
where the native library is unavailable.

Malformed-input policy (shared byte-for-byte with the native core,
``native/eventalign_parser.cpp`` — tests/test_torch_dataprep.py holds the
two paths equal on adversarial input): a line is used iff it has >= 15
tab-separated fields, reference_kmer == model_kmer, and every numeric field
parses strictly (whole field, no leading '+', no whitespace/underscores, no
overflow); anything else skips the line.  ``\\r\\n`` line endings are
tolerated.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import numpy as np

# Aggregated per-read events: positions (center-shifted), 5-mers, and the
# (dwell_time, norm_std, norm_mean) feature triplet, position-sorted.
CombinedRead = Tuple[np.ndarray, np.ndarray, np.ndarray]

# std::from_chars(double, chars_format::general) grammar: optional '-',
# then digits[.digits] | .digits with optional exponent, or inf/infinity/nan.
_FLOAT_RE = re.compile(
    rb"-?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|"
    rb"[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN])\Z"
)
_INT_RE = re.compile(rb"-?\d+\Z")
_NONZERO_DIGIT_RE = re.compile(rb"[1-9]")


def _parse_f64(b: bytes) -> Optional[float]:
    """Strict float parse matching the native core's std::from_chars: the
    whole field must parse, '+'/whitespace/underscores are rejected, and
    out-of-range magnitudes (overflow to inf, underflow to 0) are rejected."""
    if _FLOAT_RE.match(b) is None:
        return None
    v = float(b)
    if math.isinf(v) and b.lstrip(b"-")[:3].lower() != b"inf":
        return None  # overflow, e.g. "1e999" (from_chars: out_of_range)
    if v == 0.0:
        mantissa = b.split(b"e")[0].split(b"E")[0]
        if _NONZERO_DIGIT_RE.search(mantissa):
            return None  # underflow, e.g. "1e-999" (from_chars: out_of_range)
    return v


def _parse_i64(b: bytes) -> Optional[int]:
    """Strict int64 parse matching the native core's std::from_chars."""
    if _INT_RE.match(b) is None:
        return None
    v = int(b)
    if not -(1 << 63) <= v < (1 << 63):
        return None
    return v


def combine_read(events_bytes: bytes) -> Optional[CombinedRead]:
    """Aggregate one read's eventalign byte-slice.

    Returns (positions, kmers, features(n,3)) with features ordered
    (dwell_time, norm_std, norm_mean) — the column order of the reference's
    positional recarray cast (reference: m6anet/utils/dataprep_utils.py:132-135)
    — or None when fewer than two positions survive (the reference drops
    those reads via its ``data.size > 1`` check,
    reference: m6anet/utils/dataprep_utils.py:384).
    """
    positions = []
    means = []
    stdvs = []
    lengths = []
    samples = []
    kmers = []
    for line in events_bytes.split(b"\n"):
        if line.endswith(b"\r"):
            line = line[:-1]
        if not line:
            continue
        f = line.split(b"\t")
        # columns: contig, position, reference_kmer, read_index, strand,
        # event_index, event_level_mean, event_stdv, event_length, model_kmer,
        # model_mean, model_stdv, standardized_level, start_idx, end_idx
        if len(f) < 15:
            continue
        if f[2] != f[9]:  # reference_kmer == model_kmer filter
            continue
        pos = _parse_i64(f[1])
        mean = _parse_f64(f[6])
        stdv = _parse_f64(f[7])
        length = _parse_f64(f[8])
        s13 = _parse_i64(f[13])
        s14 = _parse_i64(f[14])
        if None in (pos, mean, stdv, length, s13, s14):
            continue  # malformed numeric field: skip the line
        positions.append(pos)
        kmers.append(f[2])
        means.append(mean)
        stdvs.append(stdv)
        lengths.append(length)
        samples.append(s14 - s13)

    if not positions:
        return None

    pos = np.asarray(positions, dtype=np.int64)
    w = np.asarray(samples, dtype=np.float64)  # per-event sample count weight
    mean = np.asarray(means, dtype=np.float64)
    stdv = np.asarray(stdvs, dtype=np.float64)
    dwell = np.asarray(lengths, dtype=np.float64)

    uniq, inverse = np.unique(pos, return_inverse=True)
    n = len(uniq)
    if n <= 1:
        return None

    w_sum = np.bincount(inverse, weights=w, minlength=n)
    norm_mean = np.round(np.bincount(inverse, weights=mean * w, minlength=n) / w_sum, 1)
    norm_std = np.bincount(inverse, weights=stdv * w, minlength=n) / w_sum
    dwell_time = np.bincount(inverse, weights=dwell * w, minlength=n) / w_sum

    # first occurrence of each position supplies the 5-mer
    first_idx = np.full(n, len(pos), dtype=np.int64)
    np.minimum.at(first_idx, inverse, np.arange(len(pos)))
    kmer_arr = np.asarray(kmers, dtype="S5")[first_idx]

    features = np.stack([dwell_time, norm_std, norm_mean], axis=1)
    return uniq + 2, kmer_arr, features
