"""Pooling filters: read-level representations -> site-level outputs.

The port of the production head of the JAX package's ``models/pooling.py``,
:class:`SigmoidProdPooling` (noisy-OR over a fixed block of
``n_reads_per_site`` reads; reference:
m6anet/model/model_blocks/pooling_blocks.py:101-129).  The other eleven
filters wait for ROADMAP.md's generic-model item.

Variable-read-count inference never goes through the fixed-block reshape:
it takes :meth:`SigmoidProdPooling.per_read_prob` and the segment reductions
of ``ops/site_ops.py``.
"""
from __future__ import annotations

import torch
from torch import nn


class PoolingFilter(nn.Module):
    """Marker base class: the model assembler splits the block list at the
    first PoolingFilter (reference: m6anet/model/model.py:40-69)."""


class SigmoidProdPooling(PoolingFilter):
    """Shared probability layer Linear(C, 1) + sigmoid per read; the site
    output is the noisy-OR ``1 - prod_r (1 - p_r)`` over each block of
    ``n_reads_per_site`` reads."""

    def __init__(self, input_channel: int, n_reads_per_site: int = 20):
        super().__init__()
        self.n_reads_per_site = n_reads_per_site
        self.linear = nn.Linear(input_channel, 1)  # the probability layer

    def per_read_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Per-read modification probability on the flat read axis, (N,)."""
        return torch.sigmoid(self.linear(x)).reshape(-1)

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.per_read_prob(x).reshape(-1, self.n_reads_per_site)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 1.0 - torch.prod(1.0 - self.read_level_prob(x), dim=1)
