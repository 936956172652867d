"""Feature blocks of the production MIL model, as ``nn.Module``s.

The port of the JAX package's ``models/blocks.py``
(reference: m6anet/model/model_blocks/blocks.py).  Blocks pass a dict
``{"X": signal features, "kmer": k-mer ids or embeddings}`` between them,
as the JAX blocks do.

Every block's ``forward`` takes ``train`` and ``generator`` as the JAX
blocks' ``apply`` takes ``train`` and ``rng``; only ``Linear`` uses them.

Numerics: f32 throughout, with the JAX block's formulas (blocks.py:197-220
there).  BatchNorm in eval mode is the affine map ``(y - mean) * rsqrt(var +
1e-5) * scale + bias`` over the running statistics, which ``Linear`` folds
into the linear layer's weight and bias before its one GEMM (the same
function, rounded in another order); in train mode it normalises by the batch
mean and the biased batch variance and folds the batch mean and the
*unbiased* variance into the running statistics with momentum 0.1
(torch.nn.BatchNorm1d semantics), in place, outside autograd.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _draw_(tensor: torch.Tensor, generator: torch.Generator, bound: Optional[float] = None) -> None:
    """Overwrite ``tensor`` with U(-bound, bound) draws, or N(0, 1) draws
    when ``bound`` is None, taken from ``generator`` (a CPU generator, so
    one seed gives the same values on every device)."""
    draws = torch.empty(tensor.shape, dtype=tensor.dtype)
    if bound is None:
        draws.normal_(generator=generator)
    else:
        draws.uniform_(-bound, bound, generator=generator)
    with torch.no_grad():
        tensor.copy_(draws)


def init_linear(linear: nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear's default law, as the JAX package draws it: weight and
    bias U(-1/sqrt(in), 1/sqrt(in)) (blocks.py:67-75 there)."""
    bound = 1.0 / math.sqrt(linear.in_features)
    _draw_(linear.weight, generator, bound)
    _draw_(linear.bias, generator, bound)


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

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False, generator=None) -> Dict[str, torch.Tensor]:
        return {
            "X": x["X"].reshape(-1, self.n_features),
            "kmer": x["kmer"].reshape(-1, self.n_positions),
        }


class ExtractSignal(nn.Module):
    """Drop the k-mer channel, keep only the signal features
    (reference: m6anet/model/model_blocks/blocks.py:69-86)."""

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False, generator=None) -> torch.Tensor:
        return x["X"]


class ConcatenateFeatures(nn.Module):
    """Concatenate signal features and k-mer embeddings, X first
    (reference: m6anet/model/model_blocks/blocks.py:48-66)."""

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False, generator=None) -> torch.Tensor:
        return torch.cat([x["X"], x["kmer"]], dim=1)


class Flatten(nn.Module):
    """torch.nn.Flatten(start_dim, end_dim) as the JAX block computes it: a
    negative ``end_dim`` counts from the last axis, ``start_dim`` is taken
    as given (reference: m6anet/model/model_blocks/blocks.py:129-162)."""

    def __init__(self, start_dim: int, end_dim: int):
        super().__init__()
        self.start_dim = start_dim
        self.end_dim = end_dim

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        shape = tuple(x.shape)
        end = self.end_dim if self.end_dim >= 0 else len(shape) + self.end_dim
        return x.reshape(shape[: self.start_dim] + (-1,) + shape[end + 1 :])


class KmerMultipleEmbedding(nn.Module):
    """Embed the (2w+1) 5-mer ids of each read and flatten to one vector
    (reference: m6anet/model/model_blocks/blocks.py:165-205).  Ids may arrive
    as int8 (the packed batch's type) and are widened for the lookup."""

    def __init__(self, input_channel: int, output_channel: int, num_neighboring_features: int = 1):
        super().__init__()
        self.n_positions = 2 * num_neighboring_features + 1
        self.embedding = nn.Embedding(input_channel, output_channel)

    def init(self, generator: torch.Generator) -> None:
        """torch.nn.Embedding's default law: N(0, 1)."""
        _draw_(self.embedding.weight, generator)

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False, generator=None) -> Dict[str, torch.Tensor]:
        kmer = x["kmer"].reshape(-1, self.n_positions).long()
        emb = self.embedding(kmer)
        return {"X": x["X"], "kmer": emb.reshape(-1, self.n_positions * self.embedding.embedding_dim)}


class Linear(nn.Module):
    """Linear -> (BatchNorm1d) -> activation -> (dropout)
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
        self.dropout = dropout
        # a parallel.group.DataParallel while the model trains over the
        # ranks of a job: train-mode statistics and dropout then span the
        # global batch (train.loop.make_train_step sets it)
        self.data_parallel = None

    def init(self, generator: torch.Generator) -> None:
        init_linear(self.linear, generator)
        if self.bn is not None:
            with torch.no_grad():
                self.bn.weight.fill_(1.0)
                self.bn.bias.zero_()
                self.bn.running_mean.zero_()
                self.bn.running_var.fill_(1.0)
                self.bn.num_batches_tracked.zero_()

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval-mode linear map's (weight, bias): the linear layer's,
        with eval BatchNorm, an affine map per unit, folded in (as
        fused_infer_kernel.model_tensors folds it)."""
        bn = self.bn
        if bn is None:
            return self.linear.weight, self.linear.bias
        scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
        bias = (self.linear.bias - bn.running_mean) * scale + bn.bias
        return self.linear.weight * scale[:, None], bias

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bn = self.bn
        if bn is not None and not train:
            # eval BatchNorm folded into the GEMM's weight and bias afresh each
            # call, since training moves the running statistics
            y = nn.functional.linear(x, *self.folded())
        else:
            y = self.linear(x)
        if bn is not None and train:
            dp = self.data_parallel
            if dp is not None and dp.world_size > 1:
                # the global batch's statistics: sums over every rank's rows
                # (one rank holds the whole batch, and takes the branch below)
                n = y.shape[0] * dp.world_size
                mean = dp.all_reduce_sum(y.sum(dim=0)) / n
                var = dp.all_reduce_sum((y - mean).square().sum(dim=0)) / n
            else:
                mean = y.mean(dim=0)
                var = (y - mean).square().mean(dim=0)
                n = y.shape[0]
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean)
                bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased)
            y = (y - mean) * torch.rsqrt(var + BN_EPS) * bn.weight + bn.bias
        y = self.activation(y)
        if train and self.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout requires a generator in train mode")
            keep = 1.0 - self.dropout
            if self.data_parallel is not None:
                draw = self.data_parallel.draw_rows(y.shape, generator, y.device)
            else:
                draw = torch.rand(y.shape, generator=generator, device=y.device)
            mask = draw < keep
            y = torch.where(mask, y / keep, 0.0)
        return y
