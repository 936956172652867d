"""Training/validation batch loader.

Replaces the reference's torch DataLoader + collate
(reference: m6anet/utils/builder.py:52-90, data_utils.py:509-511): sites are
read with a thread pool, each site subsampled to exactly ``min_reads`` reads
(that happens in the dataset, reference: data_utils.py:213-214), and stacked
into numpy batches ``{'X': (B, R, F) f32, 'kmer': (B, R, P) int32,
'y': (B,) f32}``, which the training loop moves to the device.  The final
batch may be short.  The port's own copy of the JAX package's
``data/loader.py``.

With more than one worker, the order in which sites draw their reads from
the dataset's shared ``rng`` is a race (as in the JAX package); one worker
gives a fixed order.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from .dataset import SiteDataset


class TrainLoader:
    def __init__(
        self,
        dataset: SiteDataset,
        batch_size: int,
        shuffle: bool = False,
        sampler=None,
        num_workers: int = 4,
        drop_last: bool = False,
        pad_to_multiple: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        # a batch axis sharded over devices needs the final short batch
        # wrap-around padded to a device-divisible size
        self.pad_to_multiple = max(1, pad_to_multiple)

    def _epoch_indices(self) -> np.ndarray:
        if self.sampler is not None:
            return np.fromiter(iter(self.sampler), dtype=np.int64)
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _load_one(self, idx: int):
        return self.dataset[int(idx)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        bs = self.batch_size
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(indices), bs):
                chunk = indices[start : start + bs]
                if len(chunk) < bs and self.drop_last:
                    break
                items = list(pool.map(self._load_one, chunk))
                n_valid = len(items)
                m = self.pad_to_multiple
                if len(items) % m:
                    target = -(-len(items) // m) * m
                    reps = -(-target // len(items))
                    items = (items * reps)[:target]
                # "n_valid" marks wrap-around padding; the training loop pops
                # it, turns it into a per-sample loss mask for the train
                # step (padded duplicates get zero loss weight) and de-pads
                # the ROC/PR metrics host-side
                yield {
                    "X": np.stack([it[0] for it in items]).astype(np.float32),
                    "kmer": np.stack([it[1] for it in items]).astype(np.int32),
                    "y": np.array([it[2] for it in items], dtype=np.float32),
                    "n_valid": n_valid,
                }
