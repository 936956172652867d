"""Site aggregation ops on the packed read axis, in plain PyTorch.

The port of the exact method of the JAX package's ``ops/site_ops.py``.  The
reference estimates a site's probability by Monte-Carlo resampling 20 reads
(reference: m6anet/utils/inference_utils.py:74-104); the estimator converges
to the closed form

    P(site) = 1 - (mean_r (1 - p_r)) ** 20

which ``site_probability_exact`` evaluates directly.  ``mod_ratio`` is the
exact fraction of reads with p >= threshold
(reference: m6anet/utils/inference_utils.py:53).  The MC method waits for
ROADMAP.md's MC slice.

Per-site sums of ``1 - p`` accumulate in float64, so the mean does not
depend on the order of summation (the CUDA kernel sums in another order);
the mean is rounded to float32 before the power, as in the JAX package.
"""
from __future__ import annotations

import torch


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


def segment_mean_one_minus_p(
    p: torch.Tensor, site_ids: torch.Tensor, counts: torch.Tensor, n_sites: int
) -> torch.Tensor:
    """mean_r (1 - p_r) per site over a flat padded read axis (float32)."""
    valid = site_ids < n_sites
    contrib = torch.where(valid, 1.0 - p, torch.zeros_like(p)).double()
    sums = _segment_sum(contrib, site_ids, n_sites)
    return (sums / torch.clamp(counts.double(), min=1.0)).to(p.dtype)


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
    hits = ((site_ids < n_sites) & (p >= threshold)).to(p.dtype)
    sums = _segment_sum(hits, site_ids, n_sites)
    return sums / torch.clamp(counts.to(p.dtype), min=1.0)
