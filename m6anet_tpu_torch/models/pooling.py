"""Pooling filters: read-level representations -> site-level outputs.

The port of the JAX package's ``models/pooling.py``: the reference's twelve
filters (reference: m6anet/model/model_blocks/pooling_blocks.py) as
``nn.Module``s with the JAX methods — ``forward`` (the JAX ``apply``),
``read_level_prob``, and ``per_read_prob`` / ``attention_weights`` where
the JAX class has them.  The production head is :class:`SigmoidProdPooling`
(noisy-OR over a fixed block of ``n_reads_per_site`` reads).

Every filter takes the read axis flat (sites * reads_per_site) with a fixed
``n_reads_per_site``.  Variable-read-count inference never goes through
these reshapes: it takes the filter's ``per_read_prob`` and the segment
reductions of ``ops/site_ops.py``.

Submodules carry the names of the JAX parameter tree's keys (``layers``,
``attention_v``, ``attention_h``, ``attention``, ``gated_attention``,
``site_decoder``, ``read_classifier``), and every ``(w, b)`` pair of that
tree is an ``nn.Linear`` called ``linear``, so ``models/convert.py`` maps
the two trees path for path.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .blocks import get_activation, init_linear


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

    def read_level_prob(self, x):
        return self(x)


class InstanceBasedPooling(PoolingFilter):
    """Shared probability layer Linear(C, 1) + sigmoid per read, viewed as
    (sites, n_reads_per_site)
    (reference: m6anet/model/model_blocks/pooling_blocks.py:26-67)."""

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


class SigmoidProdPooling(InstanceBasedPooling):
    """Noisy-OR: P(site) = 1 - prod_r (1 - p_r)
    (reference: m6anet/model/model_blocks/pooling_blocks.py:101-129)."""

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        """In train mode the product is :func:`tree_prod`, as in the JAX
        package's train step (its eval keeps XLA's product)."""
        q = 1.0 - self.read_level_prob(x)
        return 1.0 - (tree_prod(q) if train else torch.prod(q, dim=1))


class SigmoidMeanPooling(InstanceBasedPooling):
    """Mean of the read probabilities
    (reference: m6anet/model/model_blocks/pooling_blocks.py:70-98)."""

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        return self.read_level_prob(x).mean(dim=1)


class SigmoidMaxPooling(InstanceBasedPooling):
    """Max of the read probabilities
    (reference: m6anet/model/model_blocks/pooling_blocks.py:132-160).
    ``amax`` shares the gradient among tied maxima, as JAX's max does."""

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        return torch.amax(self.read_level_prob(x), dim=1)


def _over_reads(aggregate, x):
    """Apply ``aggregate`` to the signal of a ``{"X", "kmer"}`` dict (the
    k-mer entry passes through) or to a plain tensor."""
    if isinstance(x, dict):
        return {"X": aggregate(x["X"]), "kmer": x["kmer"]}
    return aggregate(x)


class SummaryStatsAggregator(PoolingFilter):
    """Per-site (mean, var, max, min, median) over reads
    (reference: m6anet/model/model_blocks/pooling_blocks.py:163-190).
    The variance is unbiased (times n / (n - 1)); the median is the lower
    middle element, sorted element (n - 1) // 2, as torch.median picks."""

    def __init__(self, input_channel: int, n_reads_per_site: int = 20):
        super().__init__()
        self.input_channel = input_channel
        self.n_reads_per_site = n_reads_per_site

    def _aggregate(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_reads_per_site
        x = x.reshape(-1, n, self.input_channel)
        mean = x.mean(dim=1)
        var = (x - x.mean(dim=1, keepdim=True)).square().mean(dim=1) * (n / max(n - 1, 1))
        med = torch.sort(x, dim=1, stable=True).values[:, (n - 1) // 2, :]
        return torch.cat([mean, var, torch.amax(x, dim=1), torch.amin(x, dim=1), med], dim=1)

    def forward(self, x, train: bool = False, generator=None):
        return _over_reads(self._aggregate, x)


class MeanAggregator(PoolingFilter):
    """Per-site mean over reads
    (reference: m6anet/model/model_blocks/pooling_blocks.py:193-215)."""

    def __init__(self, input_channel: int, n_reads_per_site: int = 20):
        super().__init__()
        self.input_channel = input_channel
        self.n_reads_per_site = n_reads_per_site

    def forward(self, x, train: bool = False, generator=None):
        return _over_reads(
            lambda v: v.reshape(-1, self.n_reads_per_site, self.input_channel).mean(dim=1), x
        )


class Dense(nn.Module):
    """One ``{"w", "b"}`` layer of the JAX package's MLP helpers."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim)


def dense_layers(in_dim: int, hidden: Sequence[int]) -> nn.ModuleList:
    """The layers of ``_mlp_init(key, in_dim, hidden)``: in_dim -> hidden[0]
    -> ... -> hidden[-1]."""
    dims = [in_dim, *hidden]
    return nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))


def init_layers(layers: nn.ModuleList, generator: torch.Generator) -> None:
    for layer in layers:
        init_linear(layer.linear, generator)


def run_layers(layers: nn.ModuleList, x: torch.Tensor, activation, last_linear: bool = True) -> torch.Tensor:
    """``_mlp_apply``: every layer but the last followed by ``activation``;
    the last too when ``last_linear`` is False."""
    for i, layer in enumerate(layers):
        x = layer.linear(x)
        if i < len(layers) - 1 or not last_linear:
            x = activation(x)
    return x


class MLP(nn.Module):
    """A ``{"layers": [...]}`` subtree: the gates of :class:`GatedAttention`."""

    def __init__(self, in_dim: int, hidden: Sequence[int]):
        super().__init__()
        self.layers = dense_layers(in_dim, hidden)

    def init(self, generator: torch.Generator) -> None:
        init_layers(self.layers, generator)

    def forward(self, x: torch.Tensor, activation) -> torch.Tensor:
        return run_layers(self.layers, x, activation)


class Attention(PoolingFilter):
    """Softmax-over-reads attention pooling
    (reference: m6anet/model/model_blocks/pooling_blocks.py:218-261).
    ``read_level_prob`` returns the attention weights, as in the JAX
    package; the filter has no per-read probability."""

    def __init__(
        self,
        input_channel: int,
        hidden_layers: Sequence[int],
        activation: str = "relu",
        n_reads_per_site: int = 20,
    ):
        super().__init__()
        self.input_channel = input_channel
        self.output_channel = list(hidden_layers)[-1]
        self.activation = get_activation(activation)
        self.n_reads_per_site = n_reads_per_site
        self.layers = dense_layers(input_channel, hidden_layers)

    def init(self, generator: torch.Generator) -> None:
        init_layers(self.layers, generator)

    def attention_weights(self, x: torch.Tensor) -> torch.Tensor:
        """(sites, K, reads): softmax over the reads, taken after the swap of
        axes 1 and 2."""
        w = run_layers(self.layers, x, self.activation)
        w = w.reshape(-1, self.n_reads_per_site, self.output_channel).transpose(1, 2)
        return torch.softmax(w, dim=2)

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention_weights(x)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        w = self.attention_weights(x)
        m = torch.einsum("skr,src->skc", w, x.reshape(-1, self.n_reads_per_site, self.input_channel))
        return m.reshape(m.shape[0], -1)


class GatedAttention(PoolingFilter):
    """Gated attention: the features through two MLPs (``activation`` and a
    sigmoid gate, each ending in a plain linear layer, as in the JAX
    package), their product fed to :class:`Attention`
    (reference: m6anet/model/model_blocks/pooling_blocks.py:313-343)."""

    def __init__(
        self,
        input_channel: int,
        hidden_layers_1: Sequence[int],
        hidden_layers_2: Sequence[int],
        activation: str = "relu",
        n_reads_per_site: int = 20,
    ):
        super().__init__()
        self.activation = get_activation(activation)
        self.gate_activation = get_activation("sigmoid")
        self.n_reads_per_site = n_reads_per_site
        self.attention_v = MLP(input_channel, hidden_layers_1)
        self.attention_h = MLP(input_channel, hidden_layers_1)
        self.attention = Attention(list(hidden_layers_1)[-1], hidden_layers_2, activation, n_reads_per_site)

    def init(self, generator: torch.Generator) -> None:
        for child in (self.attention_v, self.attention_h, self.attention):
            child.init(generator)

    def _gate(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention_v(x, self.activation) * self.attention_h(x, self.gate_activation)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        return self.attention(self._gate(x))

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention.read_level_prob(self._gate(x))

    def attention_weights(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention.attention_weights(self._gate(x))


def kde_centres(n_bins: int) -> torch.Tensor:
    """``jnp.linspace(0, 1, n_bins)`` bit for bit: ``i * (1 / (n_bins - 1))``
    in f32 with the last centre set to 1 (``torch.linspace`` rounds some
    centres the other way)."""
    if n_bins == 1:
        return torch.zeros(1)
    centres = np.arange(n_bins, dtype=np.float32) * (np.float32(1.0) / np.float32(n_bins - 1))
    centres[-1] = 1.0
    return torch.from_numpy(centres)


class _KDEBasis(PoolingFilter):
    """The Gaussian kernels shared by the KDE filters: ``n_bins`` centres on
    [0, 1] with variance ``sigma ** 2``."""

    def __init__(self, input_channel: int, n_bins: int, sigma: float, n_reads_per_site: int):
        super().__init__()
        self.input_channel = input_channel
        self.n_bins = n_bins
        self.var = sigma**2
        self.n_reads_per_site = n_reads_per_site
        self.register_buffer("centres", kde_centres(n_bins), persistent=False)

    def basis(self, x: torch.Tensor) -> torch.Tensor:
        """Soft-histogram responses of x (sites, reads, C) against the
        centres: (n_bins, sites, reads, C)."""
        coef = 1.0 / math.sqrt(2.0 * math.pi * self.var)
        return coef * torch.exp(-0.5 / self.var * torch.square(x[None] - self.centres[:, None, None, None]))

    def _per_bin(self, pool, x: torch.Tensor) -> torch.Tensor:
        """``pool`` on each bin's responses, concatenated along features."""
        basis = self.basis(x.reshape(-1, self.n_reads_per_site, self.input_channel))
        return torch.cat([pool(basis[i].reshape(-1, self.input_channel)) for i in range(self.n_bins)], dim=1)


class KDELayer(_KDEBasis):
    """Soft-histogram (KDE) pooling over reads
    (reference: m6anet/model/model_blocks/pooling_blocks.py:346-362)."""

    def __init__(self, input_channel: int, n_bins: int, sigma: float, n_reads_per_site: int = 20):
        super().__init__(input_channel, n_bins, sigma, n_reads_per_site)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        x = x.reshape(-1, self.n_reads_per_site, self.input_channel)
        k = self.basis(x).mean(dim=2)  # (bins, sites, C)
        return k.transpose(0, 1).reshape(x.shape[0], -1)


class KDEAttentionLayer(_KDEBasis):
    """Attention pooling applied per KDE bin
    (reference: m6anet/model/model_blocks/pooling_blocks.py:365-385).  As in
    the JAX package, ``read_level_prob`` is the attention on the raw
    features, and the filter has no ``attention_weights``."""

    def __init__(
        self,
        input_channel: int,
        hidden_layers: Sequence[int],
        n_bins: int,
        sigma: float,
        activation: str = "relu",
        n_reads_per_site: int = 20,
    ):
        super().__init__(input_channel, n_bins, sigma, n_reads_per_site)
        self.attention = Attention(input_channel, hidden_layers, activation, n_reads_per_site)

    def init(self, generator: torch.Generator) -> None:
        self.attention.init(generator)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        return self._per_bin(self.attention, x)

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention.read_level_prob(x)


class KDEGatedAttentionLayer(_KDEBasis):
    """Gated-attention pooling applied per KDE bin
    (reference: m6anet/model/model_blocks/pooling_blocks.py:387-412)."""

    def __init__(
        self,
        input_channel: int,
        hidden_layers_1: Sequence[int],
        hidden_layers_2: Sequence[int],
        n_bins: int,
        sigma: float,
        activation: str = "relu",
        n_reads_per_site: int = 20,
    ):
        super().__init__(input_channel, n_bins, sigma, n_reads_per_site)
        self.gated_attention = GatedAttention(
            input_channel, hidden_layers_1, hidden_layers_2, activation, n_reads_per_site
        )

    def init(self, generator: torch.Generator) -> None:
        self.gated_attention.init(generator)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        return self._per_bin(self.gated_attention, x)

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.gated_attention.read_level_prob(x)

    def attention_weights(self, x: torch.Tensor) -> torch.Tensor:
        return self.gated_attention.attention_weights(x)


READ_CLASSIFIERS = {
    "prod_pooling": SigmoidProdPooling,
    "mean_pooling": SigmoidMeanPooling,
    "max_pooling": SigmoidMaxPooling,
}


def _read_classifier(name: str, input_channel: int, n_reads_per_site: int) -> InstanceBasedPooling:
    if name not in READ_CLASSIFIERS:
        raise ValueError("Invalid read classifier name")
    return READ_CLASSIFIERS[name](input_channel, n_reads_per_site)


class ProbabilityAttention(PoolingFilter):
    """KDE-gated-attention site decoder + instance-pooling read classifier
    (reference: m6anet/model/model_blocks/pooling_blocks.py:264-288)."""

    def __init__(
        self,
        input_channel: int,
        hidden_layers_1: Sequence[int],
        hidden_layers_2: Sequence[int],
        n_bins: int,
        sigma: float,
        activation: str = "relu",
        n_reads_per_site: int = 20,
        read_classifier: str = "prod_pooling",
    ):
        super().__init__()
        self.n_reads_per_site = n_reads_per_site
        self.read_classifier = _read_classifier(read_classifier, input_channel, n_reads_per_site)
        self.site_decoder = KDEGatedAttentionLayer(
            input_channel, hidden_layers_1, hidden_layers_2, n_bins, sigma, activation, n_reads_per_site
        )

    def init(self, generator: torch.Generator) -> None:
        self.site_decoder.init(generator)
        self.read_classifier.init(generator)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        return self.site_decoder(x, train=train, generator=generator)

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.read_classifier.read_level_prob(x)

    def per_read_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.read_classifier.per_read_prob(x)

    def attention_weights(self, x: torch.Tensor) -> torch.Tensor:
        return self.site_decoder.attention_weights(x)


class SummaryStatsProbability(PoolingFilter):
    """Summary-stats site decoder + instance-pooling read classifier
    (reference: m6anet/model/model_blocks/pooling_blocks.py:291-310)."""

    def __init__(self, input_channel: int, n_reads_per_site: int = 20, read_classifier: str = "prod_pooling"):
        super().__init__()
        self.n_reads_per_site = n_reads_per_site
        self.read_classifier = _read_classifier(read_classifier, input_channel, n_reads_per_site)
        self.site_decoder = SummaryStatsAggregator(input_channel, n_reads_per_site)

    def init(self, generator: torch.Generator) -> None:
        self.read_classifier.init(generator)

    def forward(self, x, train: bool = False, generator=None):
        return self.site_decoder(x, train=train, generator=generator)

    def read_level_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.read_classifier.read_level_prob(x)

    def per_read_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.read_classifier.per_read_prob(x)
