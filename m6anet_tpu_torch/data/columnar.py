"""Columnar site store: the memory-mapped alternative to line-JSON dataprep.

The port's own copy of the JAX package's ``data/columnar.py``: the same
files, byte for byte, and the same sites.  data.json random access costs a
JSON parse per site (the reference's design,
m6anet/utils/data_utils.py:182-190).  At millions of sites the host
featurized-read path must be memory-mappable, so dataprep (``--format
columnar`` or ``both``, in either package) can also emit:

  columnar/
    features.f32.bin   (total_reads, 3*(2w+1)) float32, row-major
    read_ids.i64.bin   (total_reads,) int64
    site_offsets.npy   (n_sites + 1,) int64 prefix sums into the read axis
    site_tx.npy        (n_sites,) int32 index into transcripts list
    site_pos.npy       (n_sites,) int64 transcript positions
    site_seq.npy       (n_sites,) S(2w+5) sequence contexts
    transcripts.txt    one transcript id per line
    meta.json          version / dims / counts

The reader memory-maps the read-level arrays; batching slices rows directly —
no parsing at any point between disk and device.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional

import numpy as np

from ..constants import DEFAULT_MIN_READS, KMER_TO_INT
from .dataset import Site, _feature_indices, _subsequence
from .norm import NormDict, finalize_norm_dict, load_norm_factors, site_norm_vectors

FORMAT_VERSION = 1
SUBDIR = "columnar"


def _cached_site_norm(norm_dict, cache, seq: str, n_positions: int):
    """(mean, std) f32 vectors for a site sequence, memoized in ``cache``."""
    cached = cache.get(seq)
    if cached is None:
        mean, std = site_norm_vectors(norm_dict, seq, n_positions)
        cached = (mean.astype(np.float32), std.astype(np.float32))
        cache[seq] = cached
    return cached


class ColumnarWriter:
    """Streaming writer: append per-site feature blocks, finalize metadata."""

    def __init__(self, out_dir: str, n_positions: int):
        self.dir = os.path.join(out_dir, SUBDIR)
        os.makedirs(self.dir, exist_ok=True)
        self.n_positions = n_positions
        self.n_features = 3 * n_positions
        self._feat = open(os.path.join(self.dir, "features.f32.bin"), "wb")
        self._reads = open(os.path.join(self.dir, "read_ids.i64.bin"), "wb")
        self._tx_index = {}
        self._transcripts: List[str] = []
        self._site_tx: List[int] = []
        self._site_pos: List[int] = []
        self._site_seq: List[bytes] = []
        self._counts: List[int] = []

    def append_site(self, tx_id: str, pos: int, seq: str, features: np.ndarray, read_ids: np.ndarray):
        if tx_id not in self._tx_index:
            self._tx_index[tx_id] = len(self._transcripts)
            self._transcripts.append(tx_id)
        self._site_tx.append(self._tx_index[tx_id])
        self._site_pos.append(int(pos))
        self._site_seq.append(seq.encode())
        self._counts.append(len(features))
        self._feat.write(np.ascontiguousarray(features, dtype=np.float32).tobytes())
        self._reads.write(np.ascontiguousarray(read_ids, dtype=np.int64).tobytes())

    def finalize(self):
        self._feat.close()
        self._reads.close()
        counts = np.asarray(self._counts, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        np.save(os.path.join(self.dir, "site_offsets.npy"), offsets)
        np.save(os.path.join(self.dir, "site_tx.npy"), np.asarray(self._site_tx, np.int32))
        np.save(os.path.join(self.dir, "site_pos.npy"), np.asarray(self._site_pos, np.int64))
        np.save(os.path.join(self.dir, "site_seq.npy"), np.asarray(self._site_seq))
        with open(os.path.join(self.dir, "transcripts.txt"), "w", encoding="utf-8") as f:
            f.write("".join(t + "\n" for t in self._transcripts))
        with open(os.path.join(self.dir, "meta.json"), "w", encoding="utf-8") as f:
            json.dump(
                {
                    "version": FORMAT_VERSION,
                    "n_sites": len(counts),
                    "n_reads": int(offsets[-1]),
                    "n_positions": self.n_positions,
                    "n_features": self.n_features,
                },
                f,
            )


class ColumnarSiteDataset:
    """Memory-mapped dataset over a columnar store; same site API as
    SiteDataset, parse-free."""

    def __init__(
        self,
        root_dir: str,
        min_reads: Optional[int] = DEFAULT_MIN_READS,
        norm_path: Optional[str] = None,
        num_neighboring_features: int = 1,
        mode: str = "Inference",
        compute_norm: bool = True,
    ):
        self.root_dir = root_dir
        d = os.path.join(root_dir, SUBDIR)
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"no columnar store under {root_dir}; run dataprep with --format columnar"
            )
        with open(os.path.join(d, "meta.json"), encoding="utf-8") as f:
            self.meta = json.load(f)
        self.total_neighboring_features = (self.meta["n_positions"] - 1) // 2
        self.num_neighboring_features = num_neighboring_features
        self.n_positions = 2 * num_neighboring_features + 1
        self.indices = _feature_indices(self.total_neighboring_features, num_neighboring_features)
        self.mode = mode
        self.min_reads = min_reads if min_reads is not None else 0

        self.offsets = np.load(os.path.join(d, "site_offsets.npy"))
        self.site_tx = np.load(os.path.join(d, "site_tx.npy"))
        self.site_pos = np.load(os.path.join(d, "site_pos.npy"))
        self.site_seq = np.load(os.path.join(d, "site_seq.npy"))
        with open(os.path.join(d, "transcripts.txt"), encoding="utf-8") as f:
            self.transcripts = [line.rstrip("\n") for line in f]
        self.features = np.memmap(
            os.path.join(d, "features.f32.bin"),
            dtype=np.float32,
            mode="r",
            shape=(self.meta["n_reads"], self.meta["n_features"]),
        )
        self.read_ids = np.memmap(
            os.path.join(d, "read_ids.i64.bin"), dtype=np.int64, mode="r",
            shape=(self.meta["n_reads"],),
        )

        counts = np.diff(self.offsets)
        keep = counts >= self.min_reads
        self.labels = None
        if mode != "Inference":
            keep &= self._load_labels(mode)
        self.site_index = np.flatnonzero(keep)

        self._norm_cache = {}
        self._seq_cache = {}  # full seq -> (sub seq, kmer_ids) per-site work
        self._all_columns = len(self.indices) == self.meta["n_features"] and bool(
            np.array_equal(self.indices, np.arange(self.meta["n_features"]))
        )
        self.rng = np.random

        if norm_path:
            self.norm_dict: Optional[NormDict] = load_norm_factors(norm_path)
        elif compute_norm:
            # parity with SiteDataset, which auto-computes per-kmer factors
            # when no norm_path is given — silently training/inferring on raw
            # signal values would be a broken model
            self.norm_dict = self._compute_norm_factors()
        else:
            self.norm_dict = None  # raw features (replicate merging computes its own)

        if mode != "Inference":
            # sampler metadata, aligned with dataset indices: labels and the
            # center motif per kept site (same surface SiteDataset exposes)
            import pandas as pd

            self.labels = self.labels_full[self.site_index]
            centers = []
            for raw in self.site_index:
                seq, _ = self._seq_and_kmers(self.site_seq[raw])
                centers.append(seq[(self.n_positions - 1) // 2 :][:5])
            self.data_info = pd.DataFrame({"kmer": centers})

    def _compute_norm_factors(self) -> NormDict:
        """Per-kmer factors from this dataset's own (mode-filtered) sites,
        accumulated over the FULL stored window — the same contract as
        SiteDataset._compute_norm_factors / the reference
        (reference: m6anet/utils/norm_utils.py:43-75)."""
        if len(self.site_index) == 0:
            return {}
        sums, sqs, counts = {}, {}, {}
        for raw in self.site_index:
            start, end = int(self.offsets[raw]), int(self.offsets[raw + 1])
            seq = self.site_seq[raw].decode()
            feats = np.asarray(self.features[start:end], dtype=np.float64)
            for seg in range(len(seq) - 4):
                kmer = seq[seg : seg + 5]
                sl = feats[:, 3 * seg : 3 * (seg + 1)]
                if kmer not in sums:
                    sums[kmer], sqs[kmer], counts[kmer] = np.zeros(3), np.zeros(3), 0
                sums[kmer] += sl.sum(axis=0)
                sqs[kmer] += np.square(sl).sum(axis=0)
                counts[kmer] += len(sl)
        return finalize_norm_dict(sums, sqs, counts)

    def _load_labels(self, mode: str) -> np.ndarray:
        """Join data.info.labelled onto the columnar site table."""
        import pandas as pd

        labelled = pd.read_csv(os.path.join(self.root_dir, "data.info.labelled"))
        key = {
            (tx, int(pos)): (int(status), st)
            for tx, pos, status, st in zip(
                labelled["transcript_id"],
                labelled["transcript_position"],
                labelled["modification_status"],
                labelled["set_type"],
            )
        }
        mask = np.zeros(len(self.site_pos), dtype=bool)
        labels = np.full(len(self.site_pos), -1, dtype=np.int64)
        for i, (t, p) in enumerate(zip(self.site_tx, self.site_pos)):
            entry = key.get((self.transcripts[t], int(p)))
            if entry is not None and entry[1] == mode:
                mask[i] = True
                labels[i] = entry[0]
        self.labels_full = labels
        return mask

    def __len__(self) -> int:
        return len(self.site_index)

    @property
    def max_site_reads(self) -> int:
        if len(self.site_index) == 0:
            return 0
        counts = np.diff(self.offsets)
        return int(counts[self.site_index].max())

    def _site_norm(self, seq: str):
        return _cached_site_norm(self.norm_dict, self._norm_cache, seq, self.n_positions)

    def _seq_and_kmers(self, seq_full):
        """(sub-window sequence, kmer id row) for a stored context, memoized."""
        cached = self._seq_cache.get(seq_full)
        if cached is None:
            seq = _subsequence(
                seq_full.decode(), self.total_neighboring_features, self.num_neighboring_features
            )
            kmer_ids = np.array(
                [KMER_TO_INT[seq[i : i + 5]] for i in range(self.n_positions)], dtype=np.int32
            )
            cached = (seq, kmer_ids)
            self._seq_cache[seq_full] = cached
        return cached

    def get_site(self, idx: int, handle=None) -> Site:
        del handle
        raw = self.site_index[idx]
        start, end = self.offsets[raw], self.offsets[raw + 1]
        seq, kmer_ids = self._seq_and_kmers(self.site_seq[raw])
        if self._all_columns:
            features = np.array(self.features[start:end], dtype=np.float32)
        else:
            features = np.asarray(self.features[start:end])[:, self.indices].astype(np.float32)
        if self.norm_dict:
            mean, std = self._site_norm(seq)
            features -= mean
            features /= std
        label = None
        if self.mode != "Inference":
            label = int(self.labels_full[raw])
        return Site(
            tx_id=self.transcripts[self.site_tx[raw]],
            tx_pos=int(self.site_pos[raw]),
            read_ids=np.asarray(self.read_ids[start:end]),
            features=features,
            kmer_ids=kmer_ids,
            sequence=seq,
            label=label,
        )

    def iter_sites(self, n_threads: int = 1) -> Iterator[Site]:
        del n_threads  # memory-mapped, parse-free: threads buy nothing here
        for idx in range(len(self)):
            yield self.get_site(idx)

    def iter_packed(self, start: int, limit: Optional[int], read_capacity: int, site_capacity: int):
        """Yield padded SiteBatch objects directly from the memory map.

        Vectorized equivalent of ``pack_sites(iter_sites())``: one block copy
        per batch (plus per-site gathers only where the min_reads filter
        leaves holes), normalization applied batch-wide via np.repeat over
        read counts.  This removes the per-site Python cost of the generic
        path from the host feed.  Its batches are the same arrays, bit for
        bit, as ``pack_sites(iter_sites())`` gives over the same sites.
        """
        from .batching import SiteBatch

        idxs = self.site_index[start:]
        if limit is not None:
            idxs = idxs[:limit]
        counts_all = np.diff(self.offsets)
        n_features = len(self.indices)

        i = 0
        global_idx = start
        while i < len(idxs):
            # greedy: take sites while reads fit
            j = i
            reads = 0
            while j < len(idxs) and j - i < site_capacity:
                c = int(counts_all[idxs[j]])
                if c > read_capacity:
                    raise ValueError(
                        f"site raw={idxs[j]} has {c} reads > read_capacity {read_capacity}; "
                        "raise read_capacity (sites are capped by dataprep's readcount_max)"
                    )
                if reads + c > read_capacity:
                    break
                reads += c
                j += 1
            raws = idxs[i:j]
            counts = counts_all[raws].astype(np.int32)
            n_sites = len(raws)

            feats = np.zeros((read_capacity, n_features), np.float32)
            # int8 kmers (vocab 66): the engine ships this buffer to the
            # card verbatim — 9 MB less h2d per 1M-read batch
            kmers = np.zeros((read_capacity, self.n_positions), np.int8)
            site_ids = np.full((read_capacity,), site_capacity, np.int32)
            offsets = np.zeros((site_capacity,), np.int32)
            counts_buf = np.zeros((site_capacity,), np.int32)
            gids = np.zeros((site_capacity,), np.int32)

            # one covering block copy when the filter left few holes
            lo, hi = int(self.offsets[raws[0]]), int(self.offsets[raws[-1] + 1])
            read_rows = np.concatenate(
                [np.arange(self.offsets[r], self.offsets[r + 1]) for r in raws]
            ) if hi - lo != reads else None
            if read_rows is None:  # contiguous run
                block = np.array(self.features[lo:hi], dtype=np.float32)
                ids_block = np.asarray(self.read_ids[lo:hi])
            else:
                block = np.asarray(self.features[read_rows]).astype(np.float32)
                ids_block = np.asarray(self.read_ids[read_rows])
            if not self._all_columns:
                block = block[:, self.indices]

            sites: List[Site] = []
            boundaries = np.concatenate([[0], np.cumsum(counts)])
            # per-site metadata stays a (cached-lookup) Python loop; the
            # per-READ fills are vectorized below with np.repeat
            seq_km = [self._seq_and_kmers(self.site_seq[raw]) for raw in raws]
            for k, raw in enumerate(raws):
                seq, kmer_ids = seq_km[k]
                b0, b1 = boundaries[k], boundaries[k + 1]
                sites.append(
                    Site(
                        tx_id=self.transcripts[self.site_tx[raw]],
                        tx_pos=int(self.site_pos[raw]),
                        read_ids=ids_block[b0:b1],
                        features=None,  # packed below; CSV writer doesn't use it
                        kmer_ids=kmer_ids,
                        sequence=seq,
                        label=None,
                    )
                )
            kmers[:reads] = np.repeat(
                np.stack([km for _, km in seq_km]), counts, axis=0
            )
            site_ids[:reads] = np.repeat(np.arange(n_sites, dtype=np.int32), counts)
            offsets[:n_sites] = boundaries[:-1]
            counts_buf[:n_sites] = counts
            gids[:n_sites] = np.arange(n_sites, dtype=np.int32) + (global_idx - start)
            if self.norm_dict:
                norms = [self._site_norm(seq) for seq, _ in seq_km]
                block -= np.repeat(np.stack([m for m, _ in norms]), counts, axis=0)
                block /= np.repeat(np.stack([s for _, s in norms]), counts, axis=0)
            feats[:reads] = block

            yield SiteBatch(feats, kmers, site_ids, offsets, counts_buf, gids, sites=sites)
            global_idx += n_sites
            i = j

    def sample_reads(self, site: Site):
        sel = self.rng.choice(site.n_reads, self.min_reads, replace=False)
        return site.features[sel], np.repeat(site.kmer_ids[None, :], self.min_reads, axis=0)

    def __getitem__(self, idx: int):
        site = self.get_site(idx)
        if self.mode == "Inference":
            return site
        features, kmers = self.sample_reads(site)
        return features, kmers, site.label


class ReplicateColumnarDataset:
    """Multi-replicate inference over columnar stores.

    Same observable contract as :class:`.dataset.ReplicateSiteDataset`
    (reference: NanopolishReplicateDS,
    m6anet/utils/data_utils.py:293-495): sites outer-joined on
    (transcript, position) in first-appearance order, read counts summed
    before the ``min_reads`` gate, read ids suffixed ``"{read}_{rep}"``,
    identical sequence context asserted across replicates, and — when no
    ``norm_path`` is given — per-kmer normalization factors computed from the
    replicates themselves.  Inference mode only (training reads single-run
    datasets, as in the reference's training configs).
    """

    def __init__(
        self,
        root_dirs,
        min_reads: Optional[int] = DEFAULT_MIN_READS,
        norm_path: Optional[str] = None,
        num_neighboring_features: int = 1,
        mode: str = "Inference",
    ):
        if mode != "Inference":
            raise ValueError("ReplicateColumnarDataset supports Inference mode only")
        self.mode = mode
        self.min_reads = min_reads if min_reads is not None else 0
        # replicates stay raw (min_reads gate + normalization happen on the
        # merged site, matching the reference's summed-count semantics)
        self.reps = [
            ColumnarSiteDataset(
                d, min_reads=0, norm_path=None, compute_norm=False,
                num_neighboring_features=num_neighboring_features,
            )
            for d in root_dirs
        ]
        self.n_positions = self.reps[0].n_positions
        # suffix keyed by directory path with dict overwrite, exactly like the
        # reference's fpath_mapping (reference: m6anet/utils/data_utils.py:375)
        self.rep_suffix = {d: i for i, d in enumerate(root_dirs)}
        self.dirs = list(root_dirs)

        entries = {}
        order = []
        for r, rep in enumerate(self.reps):
            for raw in range(len(rep.site_pos)):
                key = (rep.transcripts[rep.site_tx[raw]], int(rep.site_pos[raw]))
                if key not in entries:
                    entries[key] = []
                    order.append(key)
                entries[key].append((r, raw))
        self.entries = []
        for key in order:
            total = sum(
                int(self.reps[r].offsets[raw + 1] - self.reps[r].offsets[raw])
                for r, raw in entries[key]
            )
            if total >= self.min_reads:
                self.entries.append(entries[key])

        self.norm_dict: Optional[NormDict] = (
            load_norm_factors(norm_path) if norm_path else self._compute_norm_factors()
        )
        self._norm_cache = {}

    def _compute_norm_factors(self) -> NormDict:
        """Streaming per-kmer mean/std over every replicate's reads.

        Accumulates over the FULL stored window (all positions / feature
        columns of the store), not the ``num_neighboring_features``
        sub-window the model consumes — matching
        :meth:`ReplicateSiteDataset._compute_norm_factors` and the reference
        (reference: m6anet/utils/data_utils.py:429-495, norm_utils.py:43-75).
        """
        sums, sqs, counts = {}, {}, {}
        for members in self.entries:
            for r, raw in members:
                rep = self.reps[r]
                start, end = int(rep.offsets[raw]), int(rep.offsets[raw + 1])
                seq = rep.site_seq[raw].decode()
                feats = np.asarray(rep.features[start:end], dtype=np.float64)
                for seg in range(len(seq) - 4):
                    kmer = seq[seg : seg + 5]
                    sl = feats[:, 3 * seg : 3 * (seg + 1)]
                    if kmer not in sums:
                        sums[kmer], sqs[kmer], counts[kmer] = np.zeros(3), np.zeros(3), 0
                    sums[kmer] += sl.sum(axis=0)
                    sqs[kmer] += np.square(sl).sum(axis=0)
                    counts[kmer] += len(sl)
        return finalize_norm_dict(sums, sqs, counts)

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def max_site_reads(self) -> int:
        best = 0
        for members in self.entries:
            total = sum(
                int(self.reps[r].offsets[raw + 1] - self.reps[r].offsets[raw])
                for r, raw in members
            )
            best = max(best, total)
        return best

    def get_site(self, idx: int) -> Site:
        members = [(r, self.reps[r].get_site(raw)) for r, raw in self.entries[idx]]
        seq0 = members[0][1].sequence
        for _, s in members[1:]:
            # data-integrity check — must survive `python -O` (a mismatch
            # would silently normalize with the wrong kmer factors)
            if s.sequence != seq0:
                raise ValueError(
                    f"replicates disagree on sequence context at "
                    f"{members[0][1].tx_id}:{members[0][1].tx_pos}: "
                    f"{seq0!r} vs {s.sequence!r}"
                )
        features = np.concatenate([s.features for _, s in members])
        if self.norm_dict:
            mean, std = _cached_site_norm(self.norm_dict, self._norm_cache, seq0, self.n_positions)
            features = (features - mean) / std
        read_ids = np.concatenate(
            [
                np.array([f"{int(rid)}_{self.rep_suffix[self.dirs[r]]}" for rid in s.read_ids])
                for r, s in members
            ]
        )
        first = members[0][1]
        return Site(
            tx_id=first.tx_id,
            tx_pos=first.tx_pos,
            read_ids=read_ids,
            features=features.astype(np.float32),
            kmer_ids=first.kmer_ids,
            sequence=seq0,
            label=None,
        )

    def iter_sites(self, n_threads: int = 1) -> Iterator[Site]:
        del n_threads  # memory-mapped, parse-free: threads buy nothing here
        for idx in range(len(self)):
            yield self.get_site(idx)
