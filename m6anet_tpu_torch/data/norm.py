"""Per-kmer normalization factors: loading, lookup tables, and computation.

Capability parity with the reference's norm-factor handling
(reference: m6anet/utils/norm_utils.py and m6anet/utils/data_utils.py:233-248):
each 5-mer maps to a (mean, std) pair of 3-vectors ordered
(dwell_time, norm_std, norm_mean); a site's 9-feature window is z-scored with
the concatenation of its three positional 5-mers' factors.

Native storage is ``.npz`` (kmers + (K,3) mean/std arrays); ``.joblib`` files
produced by the reference are read transparently so existing user assets keep
working.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

NormDict = Dict[str, Tuple[np.ndarray, np.ndarray]]


def load_norm_factors(path: str) -> NormDict:
    """Load normalization factors from .npz (native) or .joblib (reference)."""
    if path.endswith(".joblib"):
        import joblib

        raw = joblib.load(path)
        return {k: (np.asarray(m, np.float64), np.asarray(s, np.float64)) for k, (m, s) in raw.items()}
    data = np.load(path, allow_pickle=False)
    kmers = [k.item() if hasattr(k, "item") else str(k) for k in data["kmers"]]
    return {str(k): (data["mean"][i], data["std"][i]) for i, k in enumerate(kmers)}


def save_norm_factors(norm: NormDict, path: str) -> None:
    """Write ``norm`` as .joblib (the reference's format; needs ``joblib``)
    or, for any other name, as .npz."""
    if path.endswith(".joblib"):
        import joblib

        joblib.dump(norm, path)
        return
    kmers = sorted(norm)
    # write through a handle: np.savez(path) silently appends ".npz" when
    # the extension differs, breaking a save/load round-trip
    with open(path, "wb") as f:
        np.savez(
            f,
            kmers=np.array(kmers),
            mean=np.stack([np.asarray(norm[k][0], np.float64) for k in kmers]),
            std=np.stack([np.asarray(norm[k][1], np.float64) for k in kmers]),
        )


def site_norm_vectors(norm: NormDict, sequence: str, n_positions: int) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) 3*n_positions-vectors for a site's sequence context
    (reference: m6anet/utils/data_utils.py:233-248).

    A zero std (a kmer whose training coverage had constant signal, e.g. a
    single read) would z-score to NaN/inf; substitute 1.0 so the centered
    feature becomes 0 instead.  (The reference divides unguarded and emits
    NaN/inf rows silently — deliberate behavioural fix.)"""
    kmers = [sequence[i : i + 5] for i in range(n_positions)]
    mean = np.concatenate([norm[k][0] for k in kmers])
    std = np.concatenate([norm[k][1] for k in kmers])
    return mean, np.where(std == 0.0, 1.0, std)


def finalize_norm_dict(sums, sqs, counts) -> NormDict:
    """Convert streaming per-kmer (sum, sum-of-squares, count) accumulators
    into the (mean, std) dict.  Shared by every norm-computation path.

    Clamp: E[X^2]-E[X]^2 can cancel to a tiny negative for near-constant
    segments, which would otherwise propagate NaNs downstream."""
    norm: NormDict = {}
    for kmer in sums:
        mean = sums[kmer] / counts[kmer]
        var = np.maximum(sqs[kmer] / counts[kmer] - mean**2, 0.0)
        norm[kmer] = (mean, np.sqrt(var))
    return norm


# ---------------------------------------------------------------------------
# Computation from a labelled Train split
# (reference: m6anet/utils/norm_utils.py:13-180)
# ---------------------------------------------------------------------------


def _read_site_payload(json_path: str, tx_id: str, tx_pos: int, start: int, end: int):
    with open(json_path, "r", encoding="utf-8") as f:
        f.seek(start)
        payload = json.loads(f.read(end - start))[tx_id][str(tx_pos)]
    if len(payload) != 1:
        raise ValueError(f"site {tx_id}:{tx_pos} of {json_path} holds {len(payload)} k-mer contexts, not 1")
    kmer, features = next(iter(payload.items()))
    return kmer, np.asarray(features, dtype=np.float64)


def read_kmer(json_path: str, tx_id: str, tx_pos: int, start: int, end: int) -> str:
    """Sequence context of one site (reference: m6anet/utils/norm_utils.py:78-96)."""
    return _read_site_payload(json_path, tx_id, tx_pos, start, end)[0]


def read_features(json_path: str, tx_id: str, tx_pos: int, start: int, end: int) -> np.ndarray:
    """Feature matrix of one site (reference: m6anet/utils/norm_utils.py:99-121)."""
    return _read_site_payload(json_path, tx_id, tx_pos, start, end)[1]


def annotate_kmer_information(json_path: str, data_info, n_processes: int = 1):
    """Attach each site's sequence context to the data.info frame
    (reference: m6anet/utils/norm_utils.py:124-141).

    Single sequential pass over data.json — the sites are contiguous lines,
    so this is I/O-optimal without a worker pool.
    """
    del n_processes  # kept for CLI compatibility; the scan is I/O-bound
    kmers: List[str] = []
    with open(json_path, "r", encoding="utf-8") as f:
        for tx_id, tx_pos, start, end in zip(
            data_info["transcript_id"], data_info["transcript_position"], data_info["start"], data_info["end"]
        ):
            f.seek(start)
            payload = json.loads(f.read(end - start))[tx_id][str(tx_pos)]
            kmers.append(next(iter(payload)))
    data_info = data_info.copy()
    data_info["kmer"] = kmers
    return data_info


def compute_norm_dict(json_path: str, data_info, n_processes: int = 1) -> NormDict:
    """Streaming per-kmer mean/std over every positional segment of the
    given sites (reference: m6anet/utils/norm_utils.py:144-180).

    One sequential pass accumulating sum/sum-of-squares per 5-mer — replaces
    the reference's per-kmer repeated site reads (which re-parse each site
    once per covering kmer) with O(file) work.
    """
    del n_processes
    sums: Dict[str, np.ndarray] = {}
    sqs: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}
    with open(json_path, "r", encoding="utf-8") as f:
        for tx_id, tx_pos, start, end in zip(
            data_info["transcript_id"], data_info["transcript_position"], data_info["start"], data_info["end"]
        ):
            f.seek(start)
            payload = json.loads(f.read(end - start))[tx_id][str(tx_pos)]
            seq, features = next(iter(payload.items()))
            features = np.asarray(features, dtype=np.float64)[:, :-1]  # drop read ids
            n_positions = len(seq) - 4
            for seg in range(n_positions):
                kmer = seq[seg : seg + 5]
                sl = features[:, 3 * seg : 3 * (seg + 1)]
                if kmer not in sums:
                    sums[kmer] = np.zeros(3)
                    sqs[kmer] = np.zeros(3)
                    counts[kmer] = 0
                sums[kmer] += sl.sum(axis=0)
                sqs[kmer] += np.square(sl).sum(axis=0)
                counts[kmer] += len(sl)
    return finalize_norm_dict(sums, sqs, counts)
