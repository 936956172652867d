"""The one generator of the benchmark's traffic: staged batches drawn from a
mix's parameters (a ``traffic/<name>.json`` file) and the run's seed.

A batch is packed as the engine's ``pack_sites`` packs one: ``reads`` read
slots and ``sites`` sites laid back to back from read 0, the padding reads
after the last site.  Batch ``b`` of seed ``s`` is drawn from
``numpy.random.default_rng([s, b])`` in this order: features N(0, 1)
(``reads`` x ``features_per_read`` float32), k-mer ids uniform over
``kmer_vocab`` (``reads`` x ``kmer_positions``, int8), read counts
``clip(gamma(shape, scale), min, max)`` (int32).  That is a frozen copy of
``m6anet_tpu_torch/scripts/_sweep.py::production_batch`` (the HEK293T-shaped
law of the JAX package's ``bench.py``): at the production sizes, batch
``b`` of seed ``s`` is ``production_batch([s, b])``.

A train mix (``"kind": "train"``) stages batches in the training loader's
layout instead (:func:`make_train_batch`): ``sites`` sites of
``reads_per_site`` reads each.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class Batch(NamedTuple):
    """One staged batch, as numpy arrays."""

    features: np.ndarray  # (reads, features_per_read) float32
    kmer_ids: np.ndarray  # (reads, kmer_positions) int8
    offsets: np.ndarray  # (sites,) int32, first read of each site
    counts: np.ndarray  # (sites,) int32, reads of each site


def load(name: str) -> Dict:
    """The parameters of the traffic mix ``name``."""
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def make_batch(mix: Dict, seed: int, index: int) -> Batch:
    """Batch ``index`` of the mix under ``seed`` (see the module docstring)."""
    reads, sites = mix["reads"], mix["sites"]
    law = mix["read_counts"]
    if law["law"] != "gamma":
        raise ValueError(f"unknown read-count law {law['law']!r}")
    rng = np.random.default_rng([int(seed), int(index)])
    features = rng.normal(size=(reads, mix["features_per_read"])).astype(np.float32)
    kmer_ids = rng.integers(0, mix["kmer_vocab"], size=(reads, mix["kmer_positions"])).astype(np.int8)
    counts = np.clip(rng.gamma(law["shape"], law["scale"], size=sites), law["min"], law["max"]).astype(np.int32)
    if int(counts.sum()) > reads:
        raise ValueError(f"batch {index} of seed {seed}: its read counts overflow its {reads} reads")
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    return Batch(features, kmer_ids, offsets, counts)


class TrainBatch(NamedTuple):
    """One training batch, as the train CLI's loader and loop hand it to
    the step."""

    X: np.ndarray  # (sites, reads_per_site, features_per_read) float32
    kmer: np.ndarray  # (sites, reads_per_site, kmer_positions) int32
    y: np.ndarray  # (sites,) float32 labels
    mask: np.ndarray  # (sites,) float32, 1 for every real site (a full batch)


def make_train_batch(mix: Dict, seed: int, index: int) -> TrainBatch:
    """Batch ``index`` of a train mix under ``seed``, drawn from
    ``numpy.random.default_rng([seed, index])`` in this order: features
    N(0, 1), k-mer ids uniform over ``kmer_vocab``, labels Bernoulli(``p``)."""
    sites, reads = mix["sites"], mix["reads_per_site"]
    labels = mix["labels"]
    if labels["law"] != "bernoulli":
        raise ValueError(f"unknown label law {labels['law']!r}")
    rng = np.random.default_rng([int(seed), int(index)])
    X = rng.normal(size=(sites, reads, mix["features_per_read"])).astype(np.float32)
    kmer = rng.integers(0, mix["kmer_vocab"], size=(sites, reads, mix["kmer_positions"])).astype(np.int32)
    y = (rng.random(sites) < labels["p"]).astype(np.float32)
    return TrainBatch(X, kmer, y, np.ones(sites, np.float32))


def make_train_batches(mix: Dict, seed: int) -> List[TrainBatch]:
    return [make_train_batch(mix, seed, b) for b in range(mix["batches"])]


def make_batches(mix: Dict, seed: int, threads: int = 8) -> List[Batch]:
    """Every batch the mix stages, drawn on ``threads`` host threads (numpy
    releases the interpreter lock while it fills an array)."""
    with ThreadPoolExecutor(max(1, threads)) as pool:
        return list(pool.map(lambda b: make_batch(mix, seed, b), range(mix["batches"])))
