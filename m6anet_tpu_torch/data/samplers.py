"""Class-/motif-balancing epoch samplers for training.

Capability parity with the reference's torch Samplers
(reference: m6anet/utils/sampler_utils.py) as plain index generators: each
call to ``__iter__`` draws a fresh balanced permutation of site indices.
Resolved by name from the TOML ``[dataloader.train] sampler`` key
(reference: m6anet/utils/builder.py:76-80).  The port's own copy of the JAX
package's ``data/samplers.py``: every sampler draws from the global
``np.random`` in the same order, so one numpy seed gives both packages the
same epochs.
"""
from __future__ import annotations

import numpy as np


class _BaseSampler:
    def __init__(self, data_source):
        self.data_source = data_source
        labels = np.asarray(data_source.labels)
        self.labels = labels
        counts = np.unique(labels, return_counts=True)[1]
        self.minority_class = int(np.argmin(counts))
        self.majority_class = int(np.argmax(counts))
        self.minority_class_idx = np.flatnonzero(labels == self.minority_class)
        self.majority_class_idx = np.flatnonzero(labels == self.majority_class)


class ImbalanceUnderSampler(_BaseSampler):
    """All minority sites + an equal-size random subset of the majority
    (reference: sampler_utils.py:9-56)."""

    def __iter__(self):
        idx = np.append(
            self.minority_class_idx,
            np.random.choice(self.majority_class_idx, len(self.minority_class_idx), replace=False),
        )
        np.random.shuffle(idx)
        return iter(idx.astype(int))

    def __len__(self):
        return 2 * len(self.minority_class_idx)


class ImbalanceOverSampler(_BaseSampler):
    """All majority sites + with-replacement oversampling of the minority
    (reference: sampler_utils.py:59-102)."""

    def __iter__(self):
        idx = np.append(
            self.majority_class_idx,
            np.random.choice(self.minority_class_idx, len(self.majority_class_idx), replace=True),
        )
        np.random.shuffle(idx)
        return iter(idx.astype(int))

    def __len__(self):
        return 2 * len(self.majority_class_idx)


class _BaseKmerSampler(_BaseSampler):
    def __init__(self, data_source):
        super().__init__(data_source)
        if "kmer" not in data_source.data_info.columns:
            # motif annotation is required; derive it from data.json once
            from .norm import annotate_kmer_information

            data_source.data_info = annotate_kmer_information(
                data_source.data_fpath, data_source.data_info, 1
            )
        self.data_kmers = data_source.data_info["kmer"].values
        self.all_motifs = np.unique(self.data_kmers)
        self.minority_class_idx = {}
        self.majority_class_idx = {}
        for label, idx_dict in (
            (self.minority_class, self.minority_class_idx),
            (self.majority_class, self.majority_class_idx),
        ):
            for motif in self.all_motifs:
                mask = (self.labels == label) & (self.data_kmers == motif)
                idx_dict[motif] = np.flatnonzero(mask)
        # arithmetic length — a throwaway generate_indices() draw here would
        # both waste an epoch-sized sampling pass and advance np.random
        # before the first real epoch
        self.length = self._compute_length()

    def _compute_length(self) -> int:
        raise NotImplementedError

    def generate_indices(self):
        raise NotImplementedError

    def __iter__(self):
        return iter(self.generate_indices())

    def __len__(self):
        return self.length


class ImbalanceKmerUnderSampler(_BaseKmerSampler):
    """Per-motif undersampling of the majority class to the minority count
    (reference: sampler_utils.py:105-182)."""

    def _compute_length(self) -> int:
        total = 0
        for motif, majority_idx in self.majority_class_idx.items():
            count = len(self.minority_class_idx[motif])
            total += count if len(majority_idx) == 0 else 2 * count
        return total

    def generate_indices(self):
        parts = []
        for motif, majority_idx in self.majority_class_idx.items():
            # A motif with zero minority sites contributes nothing at all —
            # faithful to the reference, whose 0-size majority draw drops the
            # motif entirely (reference: sampler_utils.py:158-166).
            minority_idx = self.minority_class_idx[motif]
            count = len(minority_idx)
            if len(majority_idx) == 0:
                # behavioural fix: the reference crashes on a motif with only
                # minority sites (empty majority draw); keep those sites.
                parts.append(minority_idx)
                continue
            replace = len(majority_idx) < count
            parts.append(np.random.choice(majority_idx, count, replace=replace))
            parts.append(minority_idx)
        indices = np.concatenate(parts).astype(int) if parts else np.zeros(0, int)
        np.random.shuffle(indices)
        return indices


class ImbalanceKmerOverSampler(_BaseKmerSampler):
    """Per-motif oversampling of the minority class to the majority count
    (reference: sampler_utils.py:185-261)."""

    def _compute_length(self) -> int:
        total = 0
        for motif, minority_idx in self.minority_class_idx.items():
            majority_idx = self.majority_class_idx[motif]
            if len(minority_idx) == 0:
                continue
            if len(minority_idx) > len(majority_idx):
                total += len(minority_idx) + len(majority_idx)
            else:
                total += 2 * len(majority_idx)
        return total

    def generate_indices(self):
        parts = []
        for motif, minority_idx in self.minority_class_idx.items():
            majority_idx = self.majority_class_idx[motif]
            if len(minority_idx) == 0:
                # motif dropped entirely, as in the reference
                # (reference: sampler_utils.py:247-248)
                continue
            if len(minority_idx) > len(majority_idx):
                # behavioural fix: the reference asserts majority >= minority
                # per motif and dies otherwise; keep such motifs un-augmented.
                parts.append(minority_idx)
                parts.append(majority_idx)
                continue
            n_samples = len(majority_idx) - len(minority_idx)
            replace = n_samples > len(minority_idx)
            parts.append(minority_idx)
            parts.append(np.random.choice(minority_idx, n_samples, replace=replace))
            parts.append(majority_idx)
        indices = np.concatenate(parts).astype(int) if parts else np.zeros(0, int)
        np.random.shuffle(indices)
        return indices


SAMPLER_REGISTRY = {
    "ImbalanceUnderSampler": ImbalanceUnderSampler,
    "ImbalanceOverSampler": ImbalanceOverSampler,
    "ImbalanceKmerUnderSampler": ImbalanceKmerUnderSampler,
    "ImbalanceKmerOverSampler": ImbalanceKmerOverSampler,
}
