"""The MC method's shared draws ``U``, worked out again from the seed.

A frozen copy of how JAX draws them (the port replays the same):
``U = jax.random.uniform(jax.random.fold_in(PRNGKey(seed), chunk), (n_samples, T))``
in iteration chunks of ``min(T, 1024)`` columns, with JAX's default
partitionable Threefry-2x32 (20 rounds; key schedule ``k0, k1, k0 ^ k1 ^
0x1BD11BDA``; counters ``(idx >> 32, idx & 0xFFFFFFFF)``, bits ``b1 ^ b2``;
float32 from the top 23 bits as a mantissa in [1, 2), minus 1).
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for group in range(5):
            for rot in _ROTATIONS[group % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, rot) ^ x0
            x0 = x0 + ks[(group + 1) % 3]
            x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def _uniform(key, shape):
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    b1, b2 = _threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32).reshape(shape) - np.float32(1.0)


def shared_draws(seed: int, n_iters: int, n_samples: int, chunk: int = 1024) -> np.ndarray:
    """U (n_samples, n_iters) float32."""
    seed = int(seed)
    key = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)
    size = min(n_iters, chunk)
    parts = []
    for ci, start in enumerate(range(0, n_iters, size)):
        y0, y1 = _threefry2x32(key, np.zeros(1, np.uint32), np.array([ci], np.uint32))
        parts.append(_uniform(np.array([y0[0], y1[0]], np.uint32), (n_samples, min(size, n_iters - start))))
    return np.ascontiguousarray(np.concatenate(parts, axis=1))
