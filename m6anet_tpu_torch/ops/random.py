"""The MC site method's shared draws, bit for bit as the JAX package makes them.

The JAX package draws the MC method's uniform matrix ``U`` with
``jax.random.uniform(jax.random.fold_in(key, chunk), (n_samples, T))`` from
``key = PRNGKey(seed)``.  This module replays that on the host in numpy
``uint32`` arithmetic, so the port gives the same ``U`` for the same seed
without JAX.  It replays, from JAX 0.9's sources:

* ``jax/_src/prng.py::threefry_2x32`` (the Threefry-2x32 hash, 20 rounds in
  five groups of four, key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``);
* ``jax/_src/prng.py::_threefry_fold_in``: ``threefry_2x32(key, (0, i))``;
* ``jax/_src/prng.py::_threefry_random_bits_partitionable`` (JAX's default,
  ``jax_threefry_partitionable=True``): the counters are the flat index as
  ``(idx >> 32, idx & 0xFFFFFFFF)`` and the 32 bits are ``b1 ^ b2``;
* ``jax/_src/random.py::_uniform`` for float32: the top 23 bits fill the
  mantissa of a float in [1, 2), and 1 is subtracted.

This is host code: ``U`` is small (20 x n_iters floats) and is made once per
run (``shared_draws``) or once per iteration chunk (``site_ops``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` (uint32 arrays of one
    shape) under ``key`` (2,) uint32; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # uint32 adds wrap, as intended
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for group in range(5):
            for rot in _ROTATIONS[group % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, rot) ^ x0
            x0 = x0 + ks[(group + 1) % 3]
            x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def key_from_seed(seed: int) -> np.ndarray:
    """``PRNGKey(seed)``'s data: ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key: np.ndarray, i: int) -> np.ndarray:
    """``jax.random.fold_in(key, i)`` for a 32-bit ``i``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([i], np.uint32))
    return np.array([y0[0], y1[0]], dtype=np.uint32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element (the partitionable counter layout)."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(key, hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32: values in [0, 1)."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def shared_draws(seed: int, n_iters: int, n_samples: int = 20, chunk: int = 1024) -> np.ndarray:
    """The MC kernel's ``U`` (n_samples, n_iters) float32: iteration chunks
    of ``min(n_iters, chunk)`` columns side by side, chunk ``ci`` drawn from
    ``fold_in(key_from_seed(seed), ci)`` — the draws of the JAX package's
    ``site_probability_mc_pallas``."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    key = key_from_seed(seed)
    size = min(n_iters, chunk)
    parts = [
        uniform(fold_in(key, ci), (n_samples, min(size, n_iters - start)))
        for ci, start in enumerate(range(0, n_iters, size))
    ]
    return np.ascontiguousarray(np.concatenate(parts, axis=1))
