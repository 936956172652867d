"""Feature blocks of the production MIL model, as ``nn.Module``s.

The port of the JAX package's ``models/blocks.py`` for the blocks the
production config (``models/assets/configs/m6anet.toml``) uses
(reference: m6anet/model/model_blocks/blocks.py).  Blocks pass a dict
``{"X": signal features, "kmer": k-mer ids or embeddings}`` between them,
as the JAX blocks do.

Numerics: f32 throughout.  ``Linear`` applies BatchNorm in eval mode with the
JAX block's formula ``(y - mean) * rsqrt(var + 1e-5) * scale + bias``
(blocks.py:212 there); training mode and ``ExtractSignal``/``Flatten`` wait
for ROADMAP.md's generic-model and training items.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

BN_EPS = 1e-5


def get_activation(name: Optional[str]):
    """Map an activation name from a model TOML onto a tensor function
    (reference: m6anet/model/model_blocks/blocks.py:9-31)."""
    if name is None:
        return lambda x: x
    table = {
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "relu": torch.relu,
        "softmax": lambda x: torch.softmax(x, dim=1),
    }
    if name not in table:
        raise ValueError(f"Invalid activation {name!r}, must be one of {tuple(table)}")
    return table[name]


class DeaggregateNanopolish(nn.Module):
    """Flatten (site, read) leading axes into one read axis
    (reference: m6anet/model/model_blocks/blocks.py:89-126)."""

    def __init__(self, num_neighboring_features: int, n_features: int = 3):
        super().__init__()
        self.n_positions = 2 * num_neighboring_features + 1
        self.n_features = n_features * self.n_positions

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "X": x["X"].reshape(-1, self.n_features),
            "kmer": x["kmer"].reshape(-1, self.n_positions),
        }


class ConcatenateFeatures(nn.Module):
    """Concatenate signal features and k-mer embeddings, X first
    (reference: m6anet/model/model_blocks/blocks.py:48-66)."""

    def forward(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([x["X"], x["kmer"]], dim=1)


class KmerMultipleEmbedding(nn.Module):
    """Embed the (2w+1) 5-mer ids of each read and flatten to one vector
    (reference: m6anet/model/model_blocks/blocks.py:165-205).  Ids may arrive
    as int8 (the packed batch's type) and are widened for the lookup."""

    def __init__(self, input_channel: int, output_channel: int, num_neighboring_features: int = 1):
        super().__init__()
        self.n_positions = 2 * num_neighboring_features + 1
        self.embedding = nn.Embedding(input_channel, output_channel)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        kmer = x["kmer"].reshape(-1, self.n_positions).long()
        emb = self.embedding(kmer)
        return {"X": x["X"], "kmer": emb.reshape(-1, self.n_positions * self.embedding.embedding_dim)}


class Linear(nn.Module):
    """Linear -> (eval BatchNorm1d) -> activation
    (reference: m6anet/model/model_blocks/blocks.py:208-266)."""

    def __init__(
        self,
        input_channel: int,
        output_channel: int,
        activation: Optional[str] = "relu",
        batch_norm: bool = True,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.activation_name = activation
        self.activation = get_activation(activation)
        self.linear = nn.Linear(input_channel, output_channel)
        self.bn = nn.BatchNorm1d(output_channel, eps=BN_EPS) if batch_norm else None
        del dropout  # accepted from model TOMLs; dropout acts only in training

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear(x)
        if self.bn is not None:
            bn = self.bn
            y = (y - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS) * bn.weight + bn.bias
        return self.activation(y)
