"""Packing variable-read-count sites into static-shaped device batches.

Inference batches are padded to fixed capacities, so every device step sees
one shape: ``read_capacity`` total reads and ``site_capacity`` sites per
batch.  Sites are packed greedily in dataset order; padding reads carry
``site_id == site_capacity`` so segment reductions drop them
(see ops/site_ops.py).  This replaces the reference's
ragged-concatenate collate (reference: m6anet/utils/data_utils.py:498-506).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np

from .dataset import Site

# CPU defaults; the engine's CUDA defaults are 1048576 reads / 16384 sites
# (inputs are ~3 MB/batch at these caps)
DEFAULT_READ_CAPACITY = 65536
DEFAULT_SITE_CAPACITY = 1024


@dataclass
class SiteBatch:
    features: np.ndarray  # (read_capacity, 3*(2w+1)) float32
    kmer_ids: np.ndarray  # (read_capacity, 2w+1) int8 (vocab 66; the fused
    # kernel reads int8 directly — 9 MB less h2d per 1M-read batch)
    site_ids: np.ndarray  # (read_capacity,) int32; padding == site_capacity
    offsets: np.ndarray  # (site_capacity,) int32 first-read offset per site
    counts: np.ndarray  # (site_capacity,) int32 true read counts (0 = pad)
    global_ids: np.ndarray  # (site_capacity,) int32 dataset-global site index
    sites: List[Site] = field(default_factory=list)  # host-side metadata

    @property
    def n_sites(self) -> int:
        return len(self.sites)

    @property
    def n_reads(self) -> int:
        return int(self.counts.sum())


def pack_sites(
    sites: Iterator[Site],
    read_capacity: int = DEFAULT_READ_CAPACITY,
    site_capacity: int = DEFAULT_SITE_CAPACITY,
    n_features: Optional[int] = None,
    n_positions: Optional[int] = None,
) -> Iterator[SiteBatch]:
    """Greedy packing of sites into padded batches, preserving order."""

    def new_buffers(nf, npos):
        return (
            np.zeros((read_capacity, nf), np.float32),
            np.zeros((read_capacity, npos), np.int8),
            np.full((read_capacity,), site_capacity, np.int32),
            np.zeros((site_capacity,), np.int32),
            np.zeros((site_capacity,), np.int32),
            np.zeros((site_capacity,), np.int32),
        )

    buffers = None
    cursor = 0
    meta: List[Site] = []
    global_idx = 0

    for site in sites:
        n = site.n_reads
        if n > read_capacity:
            raise ValueError(
                f"site {site.tx_id}:{site.tx_pos} has {n} reads > read_capacity {read_capacity}; "
                "raise read_capacity (sites are capped by dataprep's readcount_max)"
            )
        if buffers is None:
            nf = n_features or site.features.shape[1]
            npos = n_positions or len(site.kmer_ids)
            buffers = new_buffers(nf, npos)

        if cursor + n > read_capacity or len(meta) >= site_capacity:
            yield SiteBatch(*buffers, sites=meta)
            buffers = new_buffers(buffers[0].shape[1], buffers[1].shape[1])
            cursor = 0
            meta = []

        feats, kmers, site_ids, offsets, counts, gids = buffers
        feats[cursor : cursor + n] = site.features
        kmers[cursor : cursor + n] = site.kmer_ids[None, :]
        site_ids[cursor : cursor + n] = len(meta)
        offsets[len(meta)] = cursor
        counts[len(meta)] = n
        gids[len(meta)] = global_idx
        cursor += n
        meta.append(site)
        global_idx += 1

    if meta:
        yield SiteBatch(*buffers, sites=meta)
