"""Windowed feature extraction over runs of consecutive positions.

Behavior parity with the reference's partition/roll/filter pipeline
(reference: m6anet/utils/dataprep_utils.py:19-168) built on
``sliding_window_view`` instead of ``np.roll`` concatenations: for every
position with ``w`` intact flanking neighbours on both sides, emit the
flattened (2w+1, 3) feature window (ascending position, per-position triplet
(dwell, std, mean)), the combined (2w+1)+4-mer sequence context, and keep only
windows whose *center* 5-mer is a DRACH motif.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from ..constants import M6A_KMERS
from .combine import CombinedRead

_M6A_KMERS_S5 = np.array(M6A_KMERS, dtype="S5")

# (center positions, combined-context sequences, windowed features)
WindowedRead = Tuple[np.ndarray, np.ndarray, np.ndarray]


def window_read(combined: CombinedRead, window_size: int) -> Optional[WindowedRead]:
    """Extract DRACH-centered feature windows from one aggregated read."""
    positions, kmers, features = combined
    w = window_size
    width = 2 * w + 1

    # Runs of consecutive positions (positions are sorted unique).
    breaks = np.flatnonzero(np.diff(positions) != 1) + 1
    run_starts = np.concatenate([[0], breaks])
    run_ends = np.concatenate([breaks, [len(positions)]])

    out_pos: List[np.ndarray] = []
    out_seq: List[np.ndarray] = []
    out_feat: List[np.ndarray] = []
    for s, e in zip(run_starts, run_ends):
        if e - s < width:
            # need w flanks on both sides
            # (reference: m6anet/utils/dataprep_utils.py:141-146)
            continue
        run_feat = features[s:e]
        run_kmer = kmers[s:e]
        run_pos = positions[s:e]

        centers = run_kmer[w : e - s - w]
        drach = np.isin(centers, _M6A_KMERS_S5)
        if not drach.any():
            continue

        # (n_windows, width, 3) -> flattened ascending-position windows
        fwin = sliding_window_view(run_feat, (width, 3)).reshape(-1, width * 3)[drach]

        # combined sequence: first 5-mer + last char of each following 5-mer
        # (reference: m6anet/utils/dataprep_utils.py:171-184)
        kwin = sliding_window_view(run_kmer.view(np.uint8).reshape(-1, 5), (width, 5)).reshape(
            -1, width, 5
        )[drach]
        seq = np.concatenate([kwin[:, 0, :], kwin[:, 1:, -1]], axis=1)
        seq = seq.view(f"S{width + 4}").reshape(-1)

        out_pos.append(run_pos[w : e - s - w][drach])
        out_seq.append(seq)
        out_feat.append(fwin)

    if not out_pos:
        return None
    return (
        np.concatenate(out_pos),
        np.concatenate(out_seq),
        np.concatenate(out_feat),
    )
