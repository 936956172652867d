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

from .blocks import init_linear


def tree_prod(x: torch.Tensor) -> torch.Tensor:
    """Product over dim 1 of a (B, n) tensor as a tree of elementwise
    products: halves of ceil(n/2) and floor(n/2) columns multiplied, until
    one is left.  This is the product JAX computes when it differentiates a
    product (its reduce_prod JVP rule), so a train step's site probability
    and its gradient take the JAX package's order.  Its backward is plain
    multiplication: no zero test, so no host sync (torch.prod's backward
    counts the zeros of its input on the host)."""
    while x.shape[1] > 1:
        n1 = (x.shape[1] + 1) // 2
        n2 = x.shape[1] - n1
        # JAX pads the shorter half with a 1; x * 1 is x, so the odd column
        # passes through
        x = torch.cat([x[:, :n2] * x[:, n1:], x[:, n2:n1]], dim=1)
    return x[:, 0]


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

    def init(self, generator: torch.Generator) -> None:
        init_linear(self.linear, generator)

    def per_read_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Per-read modification probability on the flat read axis, (N,)."""
        return torch.sigmoid(self.linear(x)).reshape(-1)

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.per_read_prob(x).reshape(-1, self.n_reads_per_site)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        """The noisy-OR; in train mode its product is :func:`tree_prod`, as
        in the JAX package's train step (its eval keeps XLA's product)."""
        q = 1.0 - self.read_level_prob(x)
        return 1.0 - (tree_prod(q) if train else torch.prod(q, dim=1))
