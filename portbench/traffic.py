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


def make_batches(mix: Dict, seed: int, threads: int = 8) -> List[Batch]:
    """Every batch the mix stages, drawn on ``threads`` host threads (numpy
    releases the interpreter lock while it fills an array)."""
    with ThreadPoolExecutor(max(1, threads)) as pool:
        return list(pool.map(lambda b: make_batch(mix, seed, b), range(mix["batches"])))
