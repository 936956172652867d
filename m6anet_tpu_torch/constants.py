"""Shared constants: k-mer vocabulary, DRACH motifs, defaults, pretrained registry.

The port's own copy of the JAX package's ``constants.py``: same 66-kmer
vocabulary, DRACH motifs, thresholds and four pretrained entries
(reference: m6anet/utils/constants.py:1-37), with ``asset_path`` resolving
into this package's ``models/assets/``.
"""
from __future__ import annotations

import os
from itertools import product

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "models", "assets")


def asset_path(*parts: str) -> str:
    """Resolve a packaged asset path (weights, norm factors, model configs)."""
    return os.path.join(_ASSET_DIR, *parts)


# ---------------------------------------------------------------------------
# Sequence vocabulary (reference: m6anet/utils/constants.py:29-37)
# ---------------------------------------------------------------------------
NUM_NEIGHBORING_FEATURES = 1

# DRACH definition: D=[AGT], R=[GA], A, C, H=[ACT]
CENTER_MOTIFS = [["A", "G", "T"], ["G", "A"], ["A"], ["C"], ["A", "C", "T"]]
FLANKING_MOTIFS = [["G", "A", "C", "T"] for _ in range(NUM_NEIGHBORING_FEATURES)]

# All 7-mers with a central DRACH 5-mer, decomposed into their 5-mer windows.
_ALL_7MERS = ["".join(x) for x in product(*(FLANKING_MOTIFS + CENTER_MOTIFS + FLANKING_MOTIFS))]
ALL_KMERS = np.unique(
    np.array([[s[i : i + 5] for i in range(len(s) - 4)] for s in _ALL_7MERS]).flatten()
)
KMER_TO_INT = {k: i for i, k in enumerate(ALL_KMERS)}
INT_TO_KMER = {i: k for i, k in enumerate(ALL_KMERS)}
N_KMERS = len(ALL_KMERS)  # 66

# The 18 central DRACH 5-mers that define candidate m6A sites.
M6A_KMERS = ["".join(x) for x in product(*CENTER_MOTIFS)]
M6A_KMER_SET = frozenset(M6A_KMERS)

# ---------------------------------------------------------------------------
# Defaults (reference: m6anet/utils/constants.py:8-19)
# ---------------------------------------------------------------------------
DEFAULT_MIN_READS = 20
DEFAULT_READ_THRESHOLD = 0.033379376
ARABIDOPSIS_READ_THRESHOLD = 0.0032978046219796
DEFAULT_READS_PER_SITE = 20  # MC resample width / training sample size

DEFAULT_MODEL_CONFIG = asset_path("configs", "m6anet.toml")
# the reference's signal-only variant: no k-mer embedding, the 9 signal
# features straight into the 150 -> 32 encoder
# (reference: m6anet/model/configs/model_configs/prod_pooling_signal.toml)
SIGNAL_MODEL_CONFIG = asset_path("configs", "prod_pooling_signal.toml")
# ready-to-edit training-config template (reference ships the same file class:
# m6anet/model/configs/training_configs/m6anet_train_config.toml)
TRAIN_CONFIG_TEMPLATE = asset_path("configs", "train_config.toml")

DEFAULT_PRETRAINED_MODELS = ["HCT116_RNA002", "arabidopsis_RNA002", "HEK293T_RNA004"]
DEFAULT_PRETRAINED_MODEL = "HCT116_RNA002"

# name -> (weights npz, read_proba_threshold, norm-factor npz)
# (reference: m6anet/utils/constants.py:24-27)
PRETRAINED_CONFIGS = {
    "HCT116_RNA002": (
        asset_path("weights", "rna002_hct116.npz"),
        DEFAULT_READ_THRESHOLD,
        asset_path("norm_factors", "rna002_hct116.npz"),
    ),
    "arabidopsis_RNA002": (
        asset_path("weights", "rna002_arabidopsis_virc.npz"),
        ARABIDOPSIS_READ_THRESHOLD,
        asset_path("norm_factors", "rna002_arabidopsis_virc.npz"),
    ),
    "HEK293T_RNA004": (
        asset_path("weights", "rna004_hek293t_glori.npz"),
        DEFAULT_READ_THRESHOLD,
        asset_path("norm_factors", "rna002_hct116.npz"),
    ),
    "HEK293T_RNA004_M6ACE": (
        asset_path("weights", "rna004_hek293t_m6ace.npz"),
        DEFAULT_READ_THRESHOLD,
        asset_path("norm_factors", "rna002_hct116.npz"),
    ),
}
DEFAULT_MODEL_WEIGHTS = PRETRAINED_CONFIGS[DEFAULT_PRETRAINED_MODEL][0]
DEFAULT_NORM_PATH = PRETRAINED_CONFIGS[DEFAULT_PRETRAINED_MODEL][2]

# eventalign.txt column contract (reference: m6anet/utils/dataprep_utils.py:280-282)
EVENTALIGN_COLUMNS = [
    "contig",
    "position",
    "reference_kmer",
    "read_index",
    "strand",
    "event_index",
    "event_level_mean",
    "event_stdv",
    "event_length",
    "model_kmer",
    "model_mean",
    "model_stdv",
    "standardized_level",
    "start_idx",
    "end_idx",
]
