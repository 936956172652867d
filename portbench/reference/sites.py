"""Site statistics of a packed batch, from per-read p (the reference's
definitions, m6anet/utils/inference_utils.py:53-104):

* exact: ``site_p = 1 - mean_r(1 - p_r) ** n_samples``, the closed form the
  reference's resampling estimator converges to;
* MC: ``site_p = 1 - mean_t prod_j (1 - p[off + min(floor(U[j, t] * c), c - 1)])``,
  the estimator itself with the draws ``U`` (n_samples, T) shared by every
  site; the draw index is worked out in float32, as the estimator defines it;
* ``mod_ratio = #{r : p_r >= threshold} / c``.

Site s holds the reads [offsets[s], offsets[s] + counts[s]); sites of count
0 are padding and give 0.
"""
from __future__ import annotations

import torch

from .mlp import MODES

MC_SITES_A_BLOCK = 1024  # sites whose (n_samples, T) draws one block gathers


def _site_sums(values: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per-site sums of ``values`` over each site's reads, in values' type."""
    c = torch.clamp(counts.long(), min=0)
    site = torch.repeat_interleave(torch.arange(c.shape[0], device=c.device), c)
    first = torch.repeat_interleave(offsets.long() - (torch.cumsum(c, 0) - c), c)
    reads = torch.arange(site.shape[0], device=c.device) + first
    out = torch.zeros(c.shape[0], dtype=values.dtype, device=values.device)
    return out.index_add_(0, site, values[reads])


def exact_site_p(p: torch.Tensor, offsets, counts, n_samples: int) -> torch.Tensor:
    c = counts.to(p.dtype)
    mean = _site_sums(1.0 - p, offsets, counts) / torch.clamp(c, min=1.0)
    return torch.where(counts > 0, 1.0 - mean**n_samples, torch.zeros_like(mean))


def mod_ratio(p: torch.Tensor, offsets, counts, threshold: float) -> torch.Tensor:
    hits = _site_sums((p >= threshold).long(), offsets, counts)
    ratio = hits.to(p.dtype) / torch.clamp(counts.to(p.dtype), min=1.0)
    return torch.where(counts > 0, ratio, torch.zeros_like(ratio))


def mc_site_p(p: torch.Tensor, offsets, counts, u: torch.Tensor) -> torch.Tensor:
    """``u`` is float32 (n_samples, T)."""
    n_sites = counts.shape[0]
    out = torch.zeros(n_sites, dtype=p.dtype, device=p.device)
    for a in range(0, n_sites, MC_SITES_A_BLOCK):
        c = counts[a : a + MC_SITES_A_BLOCK]
        idx = torch.floor(u.float()[:, :, None] * c.float()).long()
        idx = torch.minimum(idx, torch.clamp(c.long() - 1, min=0))
        base = torch.where(c > 0, offsets[a : a + MC_SITES_A_BLOCK], torch.zeros_like(c)).long()
        q = torch.prod(1.0 - p[base + idx], dim=0)  # (T, sites)
        site = 1.0 - q.mean(dim=0)
        out[a : a + MC_SITES_A_BLOCK] = torch.where(c > 0, site, torch.zeros_like(site))
    return out


def site_outputs(p, offsets, counts, threshold, method, n_samples, u=None):
    """``(site_p, mod_ratio)`` of the batch in p's type."""
    site_p = mc_site_p(p, offsets, counts, u) if method == "mc" else exact_site_p(p, offsets, counts, n_samples)
    return site_p, mod_ratio(p, offsets, counts, threshold)


__all__ = ["MODES", "exact_site_p", "mc_site_p", "mod_ratio", "site_outputs"]
