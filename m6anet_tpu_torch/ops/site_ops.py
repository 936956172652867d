"""Site aggregation ops on the packed read axis, in plain PyTorch.

The port of the JAX package's ``ops/site_ops.py``.  The
reference estimates a site's probability by Monte-Carlo resampling 20 reads
(reference: m6anet/utils/inference_utils.py:74-104); the estimator converges
to the closed form

    P(site) = 1 - (mean_r (1 - p_r)) ** 20

which ``site_probability_exact`` evaluates directly.  ``mod_ratio`` is the
exact fraction of reads with p >= threshold
(reference: m6anet/utils/inference_utils.py:53).  ``site_probability_mc``
replays the sampling estimator itself with draws shared by all sites, as the
JAX package's ``site_ops.site_probability_mc`` does (its ``xla`` backend;
here the ``torch`` backend).

Per-site sums of ``1 - p`` are exact integer sums of fixed-point terms, so
the mean does not depend on the order of summation on any device (the CUDA
kernel sums in another order, and CUDA's float ``index_add_`` in an order
that changes from run to run); the mean is rounded to float32 before the
power, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from . import random


def derive_site_ids(
    offsets: torch.Tensor, counts: torch.Tensor, n_reads: int, site_capacity: int
) -> torch.Tensor:
    """Per-read site ids of a ``pack_sites`` batch, from (offsets, counts).

    Site i occupies [offsets[i], offsets[i] + counts[i]) with no gaps and the
    padding reads at the tail, so a mark at every real site's first read,
    prefix-summed, gives the ids; the padding tail gets ``site_capacity``.
    Every real site must have count >= 1: a zero-count site among real ones
    would shift the ids of the sites after it (the engine checks this on the
    host before a batch is dispatched)."""
    device = offsets.device
    idx = torch.where(counts > 0, offsets.long(), torch.full_like(offsets, n_reads, dtype=torch.long))
    marks = torch.zeros(n_reads + 1, dtype=torch.int32, device=device)
    marks.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    ids = torch.cumsum(marks[:n_reads], 0, dtype=torch.int32) - 1
    total = counts.sum()
    read_index = torch.arange(n_reads, device=device)
    return torch.where(read_index < total, ids, torch.full_like(ids, site_capacity))


def integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` by binary exponentiation, in the multiplication order of
    XLA's integer power (the JAX package's ``** n_samples``)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def _segment_sum(values: torch.Tensor, site_ids: torch.Tensor, n_sites: int) -> torch.Tensor:
    """Sum of ``values`` per site; padding reads (``site_ids == n_sites``)
    must already carry zeros."""
    ids = torch.clamp(site_ids.long(), max=n_sites - 1)
    out = torch.zeros(n_sites, dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, values)


# 1 - p in [0, 1] is summed in units of 2**-32 as int64: integer adds give
# the same bits in any order, any int32 count of terms fits, and rounding a
# term moves the mean by at most 2**-33, far below its f32 resolution
_FIXED_POINT = 2.0**32


def segment_mean_one_minus_p(
    p: torch.Tensor, site_ids: torch.Tensor, counts: torch.Tensor, n_sites: int
) -> torch.Tensor:
    """mean_r (1 - p_r) per site over a flat padded read axis (float32); NaN
    for a site with a NaN read."""
    valid = site_ids < n_sites
    contrib = torch.where(valid, 1.0 - p, torch.zeros_like(p)).double()
    fixed = torch.round(torch.nan_to_num(contrib, nan=0.0) * _FIXED_POINT).long()
    sums = _segment_sum(fixed, site_ids, n_sites)
    nans = _segment_sum((valid & torch.isnan(p)).int(), site_ids, n_sites)
    mean = sums.double() / _FIXED_POINT / torch.clamp(counts.double(), min=1.0)
    return torch.where(nans > 0, torch.full_like(mean, float("nan")), mean).to(p.dtype)


def site_probability_exact(
    p: torch.Tensor,
    site_ids: torch.Tensor,
    counts: torch.Tensor,
    n_sites: int,
    n_samples: int = 20,
) -> torch.Tensor:
    """Closed-form noisy-OR site probability (see module docstring)."""
    return 1.0 - integer_pow(segment_mean_one_minus_p(p, site_ids, counts, n_sites), n_samples)


def mod_ratio_exact(
    p: torch.Tensor,
    site_ids: torch.Tensor,
    counts: torch.Tensor,
    n_sites: int,
    threshold: float,
) -> torch.Tensor:
    """Fraction of reads called modified at the given probability threshold."""
    hits = _segment_sum(((site_ids < n_sites) & (p >= threshold)).int(), site_ids, n_sites)
    return hits.to(p.dtype) / torch.clamp(counts.to(p.dtype), min=1.0)


def mc_chunk_size(n_iters: int, n_sites_cap: int, n_samples: int = 20) -> int:
    """Iterations per draw chunk of ``site_probability_mc``: at most 64, and
    fewer when the (n_samples, chunk, sites) gather would pass 96 MB (the
    JAX package's formula, kept exactly, since the chunks decide the draws)."""
    return max(1, min(n_iters, 64, (96 << 20) // max(1, n_sites_cap * n_samples * 8)))


def site_probability_mc(
    p: torch.Tensor,
    offsets: torch.Tensor,
    counts: torch.Tensor,
    key: np.ndarray,
    n_iters: int = 1000,
    n_samples: int = 20,
) -> torch.Tensor:
    """Monte-Carlo emulation of the reference's site estimator
    (reference: m6anet/utils/inference_utils.py:74-87): per site,
    ``mean_t (1 - prod_j (1 - p[offset + idx[j, t]]))`` over ``n_iters``
    iterations of ``n_samples`` reads drawn with replacement.

    Site s's j-th draw of iteration t is read ``min(floor(U[j, t] * c_s),
    c_s - 1)``, with one ``U`` per iteration chunk drawn from
    ``fold_in(key, chunk)`` (``ops/random.py``; ``key`` is
    ``random.key_from_seed(seed)``) and shared by every site, so a site's
    value depends only on (key, its reads): it does not move with the site's
    place in the batch.  Sites with count 0 give 0.  Sums are f32, as in the
    JAX package."""
    n_sites_cap = int(offsets.shape[0])
    chunk = mc_chunk_size(n_iters, n_sites_cap, n_samples)
    cntf = counts.to(p.dtype)
    cmax = torch.clamp(counts - 1, min=0)
    base = torch.where(counts > 0, offsets, torch.zeros_like(offsets)).long()
    total = torch.zeros(n_sites_cap, dtype=p.dtype, device=p.device)
    for ci, start in enumerate(range(0, n_iters, chunk)):
        size = min(chunk, n_iters - start)
        u = torch.from_numpy(random.uniform(random.fold_in(key, ci), (n_samples, size))).to(p.device)
        idx = torch.minimum((u[:, :, None] * cntf).to(torch.int32), cmax)
        draws = p[base + idx]  # (n_samples, size, S)
        prod = torch.prod(1.0 - draws, dim=0)  # (size, S)
        total = total + torch.sum(1.0 - prod, dim=0)
    mean = total / n_iters
    return torch.where(counts > 0, mean, torch.zeros_like(mean))
