"""Config-driven Multiple-Instance-Learning model assembly.

The port of the JAX package's ``models/mil.py`` (reference:
m6anet/model/model.py:7-164): a TOML ``[[block]]`` list is instantiated
through a registry of the blocks and partitioned at the first pooling
filter into read-level encoder | pooling filter | decoder.  A config with
no pooling filter builds too: every block is then the encoder, and the
site representation is the read representation.  Blocks live in
``self.blocks`` at their TOML index, so parameter names read
``blocks.<i>.<path of the JAX tree>`` (see ``models/convert.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from . import blocks as _blocks
from . import pooling as _pooling

# the 18 blocks a TOML may name (the JAX registry also lists its abstract
# bases Block, PoolingFilter and InstanceBasedPooling, which no config can
# run)
BLOCK_REGISTRY = {
    cls.__name__: cls
    for cls in (
        _blocks.DeaggregateNanopolish, _blocks.ExtractSignal, _blocks.ConcatenateFeatures, _blocks.Flatten,
        _blocks.KmerMultipleEmbedding, _blocks.Linear,
        _pooling.SigmoidProdPooling, _pooling.SigmoidMeanPooling, _pooling.SigmoidMaxPooling,
        _pooling.SummaryStatsAggregator, _pooling.MeanAggregator, _pooling.Attention, _pooling.GatedAttention,
        _pooling.KDELayer, _pooling.KDEAttentionLayer, _pooling.KDEGatedAttentionLayer,
        _pooling.ProbabilityAttention, _pooling.SummaryStatsProbability,
    )
}

NO_PER_READ_LAYER = "Pooling filter has no per-read probability layer"


def build_block(block_type: str, **kwargs) -> nn.Module:
    if block_type not in BLOCK_REGISTRY:
        raise ValueError(f"Unknown block_type {block_type!r}; available: {sorted(BLOCK_REGISTRY)}")
    return BLOCK_REGISTRY[block_type](**kwargs)


class MILModel(nn.Module):
    """Encoder blocks -> pooling filter -> decoder blocks."""

    def __init__(self, model_config: Dict):
        super().__init__()
        self.model_config = model_config
        specs = [dict(spec) for spec in model_config["block"]]
        self.blocks = nn.ModuleList(build_block(spec.pop("block_type"), **spec) for spec in specs)
        self.pooling_index: Optional[int] = next(
            (i for i, blk in enumerate(self.blocks) if isinstance(blk, _pooling.PoolingFilter)), None
        )

    @property
    def encoder(self) -> List[nn.Module]:
        return list(self.blocks[: self.pooling_index])

    @property
    def pooling(self) -> Optional[_pooling.PoolingFilter]:
        return None if self.pooling_index is None else self.blocks[self.pooling_index]

    @property
    def decoder(self) -> List[nn.Module]:
        return [] if self.pooling_index is None else list(self.blocks[self.pooling_index + 1 :])

    def init(self, generator: torch.Generator) -> "MILModel":
        """Draw every parameter from the JAX package's init laws
        (blocks.py:67-75, 160 there): linear weights and biases
        U(-1/sqrt(in), 1/sqrt(in)), embeddings N(0, 1), BatchNorm scale 1,
        bias 0, running mean 0 and variance 1.  The draws come from
        ``generator`` (a CPU ``torch.Generator``), block by block, so one
        seed gives one init on every device; it is not the JAX package's
        init for the same seed."""
        for blk in self.blocks:
            if hasattr(blk, "init"):
                blk.init(generator)
        return self

    def _run(self, blocks, x, train: bool, generator: Optional[torch.Generator]):
        for blk in blocks:
            x = blk(x, train=train, generator=generator)
        return x

    def _filter(self) -> _pooling.PoolingFilter:
        if self.pooling is None:
            raise ValueError("model config has no pooling filter")
        return self.pooling

    def per_read_filter(self) -> _pooling.PoolingFilter:
        """The pooling filter, when it has a per-read probability layer
        (``SigmoidProd/Mean/MaxPooling``, ``ProbabilityAttention``,
        ``SummaryStatsProbability``); raises the JAX package's error
        otherwise."""
        pool = self._filter()
        if not hasattr(pool, "per_read_prob"):
            raise ValueError(NO_PER_READ_LAYER)
        return pool

    def read_representation(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-read latent representation (reference: m6anet/model/model.py:85-97)."""
        return self._run(self.encoder, batch, False, None)

    def read_probability(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The filter's read-level output over fixed blocks of reads,
        (sites, n_reads_per_site) for the per-read filters; the attention
        filters give their attention weights, as in the JAX package
        (reference: m6anet/model/model.py:99-109)."""
        pool = self._filter()
        return pool.read_level_prob(self.read_representation(batch))

    def per_read_probability(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Flat per-read probabilities (N,) — the inference path
        (reference: m6anet/utils/inference_utils.py:35-37)."""
        pool = self.per_read_filter()
        return pool.per_read_prob(self.read_representation(batch))

    def site_representation(
        self,
        batch: Dict[str, torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """The pooling filter's output; the read representation itself when
        the config has no filter (reference: m6anet/model/model.py:111-120)."""
        x = self._run(self.encoder, batch, train, generator)
        if self.pooling is None:
            return x
        return self.pooling(x, train=train, generator=generator)

    def site_probability(
        self,
        batch: Dict[str, torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Site probability over fixed blocks of ``n_reads_per_site`` reads
        (reference: m6anet/model/model.py:122-131), with the JAX method's
        semantics: ``train=True`` normalises BatchNorm by the batch and
        refreshes its running statistics in place, and draws dropout from
        ``generator``."""
        y = self.site_representation(batch, train, generator)
        return self._run(self.decoder, y, train, generator)

    def read_site_probability(self, batch: Dict[str, torch.Tensor]):
        """(read-level output, site probability, read representation)
        (reference: m6anet/model/model.py:133-147)."""
        pool = self._filter()
        x = self.read_representation(batch)
        site = self._run(self.decoder, pool(x), False, None)
        return pool.read_level_prob(x), site, x

    def attention_weights(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(reference: m6anet/model/model.py:149-153)."""
        pool = self._filter()
        if not hasattr(pool, "attention_weights"):
            raise ValueError("Pooling filter does not have attention weights")
        return pool.attention_weights(self.read_representation(batch))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval-mode site probability, :meth:`site_probability`."""
        return self.site_probability(batch)


def load_model(model_config: Dict, weights_path: Optional[str] = None) -> MILModel:
    """Build a MILModel in eval mode, with converted pretrained weights when
    ``weights_path`` is given (``.npz`` or the reference's ``.pt``)."""
    from .convert import load_weights

    model = MILModel(model_config)
    if weights_path:
        model.load_state_dict(load_weights(weights_path))
    return model.eval()
