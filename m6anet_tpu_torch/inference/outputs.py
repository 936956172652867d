"""Two inference runs' outputs (``data.indiv_proba.csv`` and
``data.site_proba.csv``) held against each other.

``compare_runs`` is the one comparison the port's checks make between two
runs of the same data: two backends, two devices, two precisions, or the
port and the JAX package.  Per read within ``read_atol``; per site within
``site_atol`` + 20 max|dp| over the site's reads (site_p = 1 - m**20 moves
by at most 20 |dm|, and the mean m by at most max|dp|); the mod_ratio equal
but at sites holding a read within 1e-6 of the threshold or on the other
side of it, whose reads may fall either way.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import pandas as pd

KEYS_INDIV = ["transcript_id", "transcript_position", "read_index"]
KEYS_SITE = ["transcript_id", "transcript_position"]


def read_outputs(out_dir: str) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """A run's (indiv, site) CSVs, each sorted by its keys."""
    indiv = pd.read_csv(os.path.join(out_dir, "data.indiv_proba.csv"))
    site = pd.read_csv(os.path.join(out_dir, "data.site_proba.csv"))
    return (indiv.sort_values(KEYS_INDIV).reset_index(drop=True),
            site.sort_values(KEYS_SITE).reset_index(drop=True))


def compare_runs(got_dir: str, want_dir: str, threshold: float, read_atol: float,
                 site_atol: Optional[float] = 1e-5) -> dict:
    """The gaps between two runs' outputs, and ``ok``: the same rows (keys,
    n_reads, kmer), every value finite, every read within ``read_atol``,
    every site within ``site_atol`` + 20 max|dp| over its reads, and every
    mod_ratio equal off the threshold.  ``site_atol=None`` leaves the sites
    unheld: their gaps are still reported, ``site_over_allowed`` against 20
    max|dp| alone."""
    (got_i, got_s), (want_i, want_s) = read_outputs(got_dir), read_outputs(want_dir)
    gaps = {"rows": [len(got_i), len(got_s)], "want_rows": [len(want_i), len(want_s)]}
    same_rows = (
        gaps["rows"] == gaps["want_rows"]
        and (got_i[KEYS_INDIV].values == want_i[KEYS_INDIV].values).all()
        and (got_s[KEYS_SITE].values == want_s[KEYS_SITE].values).all()
        and (got_s.n_reads.values == want_s.n_reads.values).all()
        and (got_s.kmer.values == want_s.kmer.values).all()
    )
    gaps["same_rows"] = bool(same_rows)
    if not same_rows:
        gaps["ok"] = False
        return gaps
    p, q = got_i.probability_modified.values, want_i.probability_modified.values
    values = np.concatenate([p, got_s.probability_modified.values, got_s.mod_ratio.values])
    gap = np.abs(p - q)
    keys_i = pd.MultiIndex.from_frame(got_i[KEYS_SITE])
    keys_s = pd.MultiIndex.from_frame(got_s[KEYS_SITE])
    site_gap = pd.Series(gap, index=keys_i).groupby(level=[0, 1]).max().loc[keys_s].values
    near = (np.abs(q - threshold) < 1e-6) | ((p >= threshold) != (q >= threshold))
    near = pd.Series(near, index=keys_i).groupby(level=[0, 1]).any().loc[keys_s].values
    site_err = np.abs(got_s.probability_modified.values - want_s.probability_modified.values)
    allowed = (site_atol or 0.0) + 20 * site_gap
    mr_gap = np.abs(got_s.mod_ratio.values - want_s.mod_ratio.values)
    gaps.update(
        finite=bool(np.isfinite(values).all()),
        indiv=float(gap.max(initial=0.0)),
        reads_over_read_atol=int((gap > read_atol).sum()),
        site=float(site_err.max(initial=0.0)),
        site_over_allowed=float((site_err / np.maximum(allowed, 1e-30)).max(initial=0.0)),
        mod_ratio_clear_sites=float(mr_gap[~near].max(initial=0.0)),
        sites_near_threshold=int(near.sum()),
    )
    gaps["ok"] = bool(
        gaps["finite"] and gaps["reads_over_read_atol"] == 0 and gaps["mod_ratio_clear_sites"] == 0
        and (site_atol is None or (site_err <= allowed).all())
    )
    return gaps
