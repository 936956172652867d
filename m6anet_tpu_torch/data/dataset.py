"""Site datasets over dataprep output (data.json + data.info).

Capability parity with the reference's dataset layer
(reference: m6anet/utils/data_utils.py:20-495 — NanopolishDS and
NanopolishReplicateDS), re-designed for a device-feed pipeline: instead of a
torch DataLoader doing per-site seeks in worker processes, a dataset here is
an ordered collection of sites whose payloads are read with a single
file handle in offset order (data.json lines are contiguous, so scanning in
data.info order is near-sequential I/O) and packed into flat, padded device
batches by data/batching.py.

Feature normalization, neighbour sub-window selection, train-mode read
sampling and the replicate merge semantics all follow the reference contract.
"""
from __future__ import annotations

import os
import json
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from ..constants import DEFAULT_MIN_READS, KMER_TO_INT
from .norm import (
    NormDict,
    annotate_kmer_information,
    compute_norm_dict,
    finalize_norm_dict,
    load_norm_factors,
    site_norm_vectors,
)

ALLOWED_MODES = ("Train", "Test", "Val", "Inference")


@dataclass
class Site:
    """One candidate DRACH site, ready for batching."""

    tx_id: str
    tx_pos: int
    read_ids: np.ndarray  # int64 for single-run; unicode for replicates
    features: np.ndarray  # (n_reads, 3*(2w+1)) float32, normalized
    kmer_ids: np.ndarray  # (2w+1,) int32 vocabulary ids
    sequence: str  # (2w+5)-mer context
    label: Optional[int] = None

    @property
    def n_reads(self) -> int:
        return len(self.features)

    @property
    def center_kmer(self) -> str:
        n_pos = len(self.kmer_ids)
        return self.sequence[(n_pos - 1) // 2 :][:5]


def _threaded_site_iter(get_site, n: int, n_threads: int) -> Iterator[Site]:
    """Windowed thread-pool iteration over ``get_site(idx)`` in index order.

    Payload reads and the native JSON parse release the GIL, so this scales
    with host cores while preserving output order (a bounded look-ahead
    window keeps memory O(n_threads), not O(dataset))."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        window = n_threads * 4
        futures = {idx: pool.submit(get_site, idx) for idx in range(min(window, n))}
        for idx in range(n):
            site = futures.pop(idx).result()
            nxt = idx + window
            if nxt < n:
                futures[nxt] = pool.submit(get_site, nxt)
            yield site


def _feature_indices(total_w: int, w: int) -> np.ndarray:
    """Column indices selecting the central (2w+1) positions' triplets from a
    (2*total_w+1)-position feature row
    (reference: m6anet/utils/data_utils.py:105-116)."""
    positions = range(total_w - w, total_w + w + 1)
    return np.array([3 * p + i for p in positions for i in range(3)], dtype=np.int64)


def _subsequence(sequence: str, total_w: int, w: int) -> str:
    """Central (2w+5)-mer of the stored (2*total_w+5)-mer context.

    (reference: m6anet/utils/data_utils.py:266-279 — whose slice arithmetic
    is wrong for total_w > w; that path is unreachable with the reference's
    shipped data, which always has total_w == 1.  Fixed here.)"""
    if w < total_w:
        start = total_w - w
        return sequence[start : start + 2 * w + 5]
    return sequence


class SiteDataset:
    """Single-run dataset (reference: NanopolishDS, data_utils.py:20-290)."""

    def __init__(
        self,
        root_dir: str,
        min_reads: Optional[int] = DEFAULT_MIN_READS,
        norm_path: Optional[str] = None,
        num_neighboring_features: int = 1,
        mode: str = "Inference",
        n_processes: int = 1,
    ):
        if mode not in ALLOWED_MODES:
            raise ValueError(f"Invalid mode {mode!r}, must be one of {ALLOWED_MODES}")
        if root_dir is None:
            raise ValueError("Either root directory or data info must be given")
        if num_neighboring_features > 5:
            raise ValueError(f"Invalid neighboring features number {num_neighboring_features}")

        self.root_dir = root_dir
        self.min_reads = min_reads if min_reads is not None else 0
        self.mode = mode
        self.num_neighboring_features = num_neighboring_features
        self.n_positions = 2 * num_neighboring_features + 1

        self._initialize_data_info()

        if norm_path is not None:
            self.norm_dict: Optional[NormDict] = load_norm_factors(norm_path)
        else:
            self.norm_dict = self._compute_norm_factors(n_processes)

        self.total_neighboring_features = self._infer_total_neighboring_features()
        self.indices = _feature_indices(self.total_neighboring_features, num_neighboring_features)

        if self.mode != "Inference":
            self.labels = self.data_info["modification_status"].values

        # train-mode read subsampling source; swap for reproducibility
        self.rng = np.random
        self._norm_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._kmer_id_cache: Dict[str, np.ndarray] = {}

    # -------------------------------------------------------------- init bits
    def _initialize_data_info(self):
        if self.mode == "Inference":
            data_info = pd.read_csv(os.path.join(self.root_dir, "data.info"))
        else:
            data_info = pd.read_csv(os.path.join(self.root_dir, "data.info.labelled"))
            data_info = data_info[data_info["set_type"] == self.mode].reset_index(drop=True)
        self.data_fpath = os.path.join(self.root_dir, "data.json")
        self.data_info = data_info[data_info["n_reads"] >= self.min_reads].reset_index(drop=True)
        # plain-array row access (pandas .iloc per site dominates otherwise)
        self._tx_arr = self.data_info["transcript_id"].to_numpy()
        self._pos_arr = self.data_info["transcript_position"].to_numpy()
        self._start_arr = self.data_info["start"].to_numpy()
        self._end_arr = self.data_info["end"].to_numpy()

    def _compute_norm_factors(self, n_processes: int) -> NormDict:
        if len(self.data_info) == 0:
            return {}
        if "kmer" not in self.data_info.columns:
            self.data_info = annotate_kmer_information(self.data_fpath, self.data_info, n_processes)
        return compute_norm_dict(self.data_fpath, self.data_info, n_processes)

    def _infer_total_neighboring_features(self) -> int:
        if len(self.data_info) == 0:
            return self.num_neighboring_features
        row = self.data_info.iloc[0]
        seq, _ = self._load_payload(
            self.data_fpath, row["transcript_id"], row["transcript_position"], row["start"], row["end"]
        )
        return (len(seq) - 5) // 2

    # ------------------------------------------------------------------ access
    @staticmethod
    def _load_payload(fpath: str, tx_id: str, tx_pos: int, start: int, end: int, handle=None, n_cols=None):
        """Read one site payload.

        When the feature width is known (``n_cols``), parsing goes through the
        native data.json parser (native/ea_parse_site_json) — an
        order of magnitude faster than json.loads on the float-heavy lines —
        with stdlib json as the fallback.
        """
        if handle is None:
            with open(fpath, "rb") as f:
                f.seek(start)
                raw = f.read(end - start)
        else:
            handle.seek(start)
            raw = handle.read(end - start)
        if isinstance(raw, str):
            raw = raw.encode()
        if n_cols is not None:
            from ..native import native_parse_site_json

            parsed = native_parse_site_json(raw, n_cols)
            if parsed is not None:
                return parsed
        payload = json.loads(raw)[tx_id][str(int(tx_pos))]
        assert len(payload) == 1
        seq, features = next(iter(payload.items()))
        return seq, np.asarray(features, dtype=np.float64)

    def __len__(self) -> int:
        return len(self.data_info)

    @property
    def max_site_reads(self) -> int:
        """Largest per-site read count (capacity validation happens at
        dataset-build time, not mid-run — the reference streams any site
        size, reference: m6anet/utils/data_utils.py:226-229)."""
        return int(self.data_info["n_reads"].max()) if len(self.data_info) else 0

    def _site_from_payload(self, tx_id, tx_pos, seq, raw_features, label=None) -> Site:
        read_ids = raw_features[:, -1].astype(np.int64)
        features = raw_features[:, self.indices]
        sub_seq = _subsequence(seq, self.total_neighboring_features, self.num_neighboring_features)
        kmers = [sub_seq[i : i + 5] for i in range(self.n_positions)]

        if self.norm_dict:
            cached = self._norm_cache.get(sub_seq)
            if cached is None:
                cached = site_norm_vectors(self.norm_dict, sub_seq, self.n_positions)
                self._norm_cache[sub_seq] = cached
            mean, std = cached
            features = (features - mean) / std

        kmer_ids = self._kmer_id_cache.get(sub_seq)
        if kmer_ids is None:
            kmer_ids = np.array([KMER_TO_INT[k] for k in kmers], dtype=np.int32)
            self._kmer_id_cache[sub_seq] = kmer_ids
        return Site(
            tx_id=tx_id,
            tx_pos=int(tx_pos),
            read_ids=read_ids,
            features=features.astype(np.float32),
            kmer_ids=kmer_ids,
            sequence=sub_seq,
            label=label,
        )

    def get_site(self, idx: int, handle=None) -> Site:
        tx_id = self._tx_arr[idx]
        tx_pos = self._pos_arr[idx]
        n_cols = 3 * (2 * self.total_neighboring_features + 1) + 1
        seq, raw = self._load_payload(
            self.data_fpath, tx_id, tx_pos,
            self._start_arr[idx], self._end_arr[idx], handle, n_cols=n_cols,
        )
        label = None if self.mode == "Inference" else int(self.labels[idx])
        return self._site_from_payload(tx_id, tx_pos, seq, raw, label)

    def iter_sites(self, n_threads: int = 1) -> Iterator[Site]:
        """Stream sites in data.info order.

        Default is a sequential scan with one persistent handle (fastest on
        few-core hosts; the engine overlaps it with device compute via its
        prefetch thread).  ``n_threads > 1`` parses payloads on a thread pool
        with thread-local handles — the native data.json parser releases the
        GIL, so this scales on many-core hosts.
        """
        if n_threads <= 1 or len(self) < 32:
            with open(self.data_fpath, "rb") as f:
                for idx in range(len(self)):
                    yield self.get_site(idx, handle=f)
            return

        import threading
        from concurrent.futures import ThreadPoolExecutor

        local = threading.local()
        handles = []
        handles_lock = threading.Lock()

        def load(idx):
            handle = getattr(local, "handle", None)
            if handle is None:
                handle = local.handle = open(self.data_fpath, "rb")
                with handles_lock:
                    handles.append(handle)
            return self.get_site(idx, handle=handle)

        try:
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                window = n_threads * 4
                futures = {}
                for idx in range(min(window, len(self))):
                    futures[idx] = pool.submit(load, idx)
                for idx in range(len(self)):
                    site = futures.pop(idx).result()
                    nxt = idx + window
                    if nxt < len(self):
                        futures[nxt] = pool.submit(load, nxt)
                    yield site
        finally:
            for h in handles:
                h.close()

    # ------------------------------------------------------- training access
    def sample_reads(self, site: Site) -> Tuple[np.ndarray, np.ndarray]:
        """Sample exactly min_reads reads without replacement (train modes)
        (reference: m6anet/utils/data_utils.py:213-214)."""
        sel = self.rng.choice(site.n_reads, self.min_reads, replace=False)
        return site.features[sel], np.repeat(site.kmer_ids[None, :], self.min_reads, axis=0)

    def __getitem__(self, idx: int):
        site = self.get_site(idx)
        if self.mode == "Inference":
            return site
        features, kmers = self.sample_reads(site)
        return features, kmers, site.label


class ReplicateSiteDataset(SiteDataset):
    """Multi-replicate dataset (reference: NanopolishReplicateDS,
    data_utils.py:293-495): sites outer-joined on (transcript, position),
    read counts summed, read ids suffixed with their replicate number."""

    def __init__(
        self,
        root_dir: Sequence[str],
        min_reads: Optional[int] = DEFAULT_MIN_READS,
        norm_path: Optional[str] = None,
        num_neighboring_features: int = 1,
        mode: str = "Inference",
        n_processes: int = 1,
    ):
        self.root_dirs = list(root_dir)
        super().__init__(
            root_dir=self.root_dirs,  # type: ignore[arg-type]
            min_reads=min_reads,
            norm_path=norm_path,
            num_neighboring_features=num_neighboring_features,
            mode=mode,
            n_processes=n_processes,
        )

    def _initialize_data_info(self):
        if self.mode == "Inference":
            suffix = "data.info"
            keys = ["transcript_id", "transcript_position"]
        else:
            suffix = "data.info.labelled"
            keys = ["transcript_id", "transcript_position", "modification_status", "set_type"]

        frames = [
            pd.read_csv(os.path.join(d, suffix)).assign(fpath=d).set_index(keys) for d in self.root_dirs
        ]
        merged = pd.concat(frames, axis=1)
        n_reads = merged["n_reads"].sum(axis=1).astype(int).reset_index(drop=True)
        starts = merged["start"].apply(lambda r: [int(v) for v in r if v == v], axis=1)
        ends = merged["end"].apply(lambda r: [int(v) for v in r if v == v], axis=1)
        fpaths = merged["fpath"].apply(lambda r: [v for v in r if v == v], axis=1).reset_index(drop=True)
        coords = pd.concat([starts, ends], axis=1).apply(
            lambda r: list(zip(r.iloc[0], r.iloc[1])), axis=1
        ).reset_index(drop=True)

        info = merged.reset_index()[keys]
        info["n_reads"] = n_reads
        info["coords"] = coords
        info["fpath"] = fpaths

        if self.mode != "Inference":
            info = info[info["set_type"] == self.mode]

        self.data_info = info[info["n_reads"] >= self.min_reads].reset_index(drop=True)
        self.rep_number = {d: i for i, d in enumerate(self.root_dirs)}
        self.data_fpath = None  # sites span several files
        # plain-array row access (iloc per site dominates otherwise) + one
        # persistent handle per (thread, replicate file)
        import threading

        self._tx_arr = self.data_info["transcript_id"].to_numpy()
        self._pos_arr = self.data_info["transcript_position"].to_numpy()
        self._coords_list = self.data_info["coords"].tolist()
        self._fpath_list = self.data_info["fpath"].tolist()
        self._local = threading.local()

    def _dir_handle(self, d: str):
        """Thread-local persistent handle for one replicate's data.json (the
        previous revision re-opened the file once per site per replicate)."""
        handles = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        h = handles.get(d)
        if h is None:
            h = handles[d] = open(os.path.join(d, "data.json"), "rb")
        return h

    def _infer_total_neighboring_features(self) -> int:
        if len(self.data_info) == 0:
            return self.num_neighboring_features
        row = self.data_info.iloc[0]
        start, end = row["coords"][0]
        fpath = os.path.join(row["fpath"][0], "data.json")
        seq, _ = self._load_payload(fpath, row["transcript_id"], row["transcript_position"], start, end)
        return (len(seq) - 5) // 2

    @staticmethod
    def _payload_any(raw: bytes):
        """Parse one data.json line without knowing its (tx, pos) keys."""
        obj = json.loads(raw)
        seq, feats = next(iter(next(iter(next(iter(obj.values())).values())).items()))
        return seq, np.asarray(feats, dtype=np.float64)

    def _compute_norm_factors(self, n_processes: int) -> NormDict:
        """Aggregate streaming sum/sum² across every replicate
        (reference: m6anet/utils/data_utils.py:429-495).

        One pass per replicate file in byte-offset order (near-sequential
        I/O) with the native payload parser — the previous revision
        re-opened + stdlib-json-parsed every payload per data_info row.
        Per-kmer accumulation order differs from the reference's per-site
        order only in float summation order (~1e-15 relative)."""
        del n_processes
        if len(self.data_info) == 0:
            return {}
        from ..native import native_parse_site_json

        per_dir: Dict[str, List[Tuple[int, int]]] = {}
        for coords, fpaths in zip(self._coords_list, self._fpath_list):
            for (start, end), d in zip(coords, fpaths):
                per_dir.setdefault(d, []).append((int(start), int(end)))

        sums: Dict[str, np.ndarray] = {}
        sqs: Dict[str, np.ndarray] = {}
        counts: Dict[str, int] = {}
        n_cols = None
        for d, coord_list in per_dir.items():
            coord_list.sort()
            with open(os.path.join(d, "data.json"), "rb") as f:
                for start, end in coord_list:
                    f.seek(start)
                    raw = f.read(end - start)
                    parsed = (
                        native_parse_site_json(raw, n_cols) if n_cols is not None else None
                    )
                    if parsed is None:
                        seq, feats = self._payload_any(raw)
                        if n_cols is None:
                            n_cols = feats.shape[1]
                    else:
                        seq, feats = parsed
                    feats = feats[:, :-1]
                    for seg in range(len(seq) - 4):
                        kmer = seq[seg : seg + 5]
                        sl = feats[:, 3 * seg : 3 * (seg + 1)]
                        if kmer not in sums:
                            sums[kmer], sqs[kmer], counts[kmer] = np.zeros(3), np.zeros(3), 0
                        sums[kmer] += sl.sum(axis=0)
                        sqs[kmer] += np.square(sl).sum(axis=0)
                        counts[kmer] += len(sl)
        return finalize_norm_dict(sums, sqs, counts)

    def get_site(self, idx: int, handle=None) -> Site:
        del handle  # replicate sites span several files; see _dir_handle
        tx_id = self._tx_arr[idx]
        tx_pos = self._pos_arr[idx]
        all_feats: List[np.ndarray] = []
        all_reads: List[np.ndarray] = []
        seq0 = None
        n_cols = 3 * (2 * self.total_neighboring_features + 1) + 1
        for (start, end), d in zip(self._coords_list[idx], self._fpath_list[idx]):
            seq, raw = self._load_payload(
                os.path.join(d, "data.json"), tx_id, tx_pos,
                start, end, handle=self._dir_handle(d), n_cols=n_cols,
            )
            if seq0 is None:
                seq0 = seq
            elif seq0 != seq:
                # data-integrity check — must survive `python -O`
                raise ValueError(
                    f"replicates disagree on sequence context at "
                    f"{tx_id}:{tx_pos}: {seq0!r} vs {seq!r}"
                )
            rep = self.rep_number[d]
            all_feats.append(raw)
            # vectorized "{read}_{rep}" suffixing (reference: data_utils.py:423)
            all_reads.append(
                np.char.add(raw[:, -1].astype(np.int64).astype("U20"), f"_{rep}")
            )
        raw = np.concatenate(all_feats)
        label = None if self.mode == "Inference" else int(self.labels[idx])
        site = self._site_from_payload(tx_id, tx_pos, seq0, raw, label)
        site.read_ids = np.concatenate(all_reads)
        return site

    def iter_sites(self, n_threads: int = 1) -> Iterator[Site]:
        if n_threads > 1 and len(self) >= 32:
            yield from _threaded_site_iter(self.get_site, len(self), n_threads)
            return
        for idx in range(len(self)):
            yield self.get_site(idx)


def build_dataset(
    root_dir: Union[str, Sequence[str]],
    **kwargs,
) -> SiteDataset:
    """Dataset factory: str -> SiteDataset, list -> ReplicateSiteDataset
    (reference: m6anet/utils/builder.py:26-49)."""
    if isinstance(root_dir, (list, tuple)):
        if len(root_dir) == 1:
            raise ValueError("root_dir is a list but of size 1, please pass root_dir as a string instead")
        return ReplicateSiteDataset(root_dir, **kwargs)
    if isinstance(root_dir, str):
        return SiteDataset(root_dir, **kwargs)
    raise ValueError("Invalid type for argument root_dir")


class ConcatSiteDataset:
    """Disjoint shard concatenation: several dataprep output directories
    treated as ONE dataset (per-host dataprep shards; unlike
    ReplicateSiteDataset the shards cover different transcripts, so read ids
    are kept as-is and nothing is pooled).  ``columnar=True`` reads each
    shard's columnar store instead of data.json.

    ``norm_path`` is required: per-shard factors computed from each shard's
    own sites would normalize one logical dataset inconsistently shard by
    shard.  Pass the factors the whole dataset shares (the JAX package's
    ``compute_norm_factors`` computes them once)."""

    def __init__(self, root_dirs: Sequence[str], columnar: bool = False, **kwargs):
        if kwargs.get("norm_path") is None:
            # each shard would auto-compute factors over only its own
            # sites, normalizing one logical dataset inconsistently
            raise ValueError(
                "concatenated shards form ONE dataset and need an explicit "
                "norm_path; per-shard auto-computed factors would differ"
            )
        if columnar:
            from .columnar import ColumnarSiteDataset

            self.parts = [ColumnarSiteDataset(d, **kwargs) for d in root_dirs]
        else:
            self.parts = [SiteDataset(d, **kwargs) for d in root_dirs]
        self._offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    @property
    def max_site_reads(self) -> int:
        return max((p.max_site_reads for p in self.parts), default=0)

    def get_site(self, idx: int) -> Site:
        part = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.parts[part].get_site(idx - int(self._offsets[part]))

    def iter_sites(self, n_threads: int = 1) -> Iterator[Site]:
        for part in self.parts:
            yield from part.iter_sites(n_threads=n_threads)
