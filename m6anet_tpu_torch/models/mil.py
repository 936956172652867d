"""Config-driven Multiple-Instance-Learning model assembly.

The port of the JAX package's ``models/mil.py`` (reference:
m6anet/model/model.py:7-164): a TOML ``[[block]]`` list is instantiated
through a registry of the ported blocks and partitioned at the first pooling
filter into read-level encoder | pooling filter | decoder.  Blocks live in
``self.blocks`` at their TOML index, so parameter names read
``blocks.<i>.<layer>.<tensor>`` (see ``models/convert.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from . import blocks as _blocks
from . import pooling as _pooling

BLOCK_REGISTRY = {
    "DeaggregateNanopolish": _blocks.DeaggregateNanopolish,
    "KmerMultipleEmbedding": _blocks.KmerMultipleEmbedding,
    "ConcatenateFeatures": _blocks.ConcatenateFeatures,
    "Linear": _blocks.Linear,
    "SigmoidProdPooling": _pooling.SigmoidProdPooling,
}


def build_block(block_type: str, **kwargs) -> nn.Module:
    if block_type not in BLOCK_REGISTRY:
        raise ValueError(
            f"block_type {block_type!r} is not ported to m6anet_tpu_torch yet "
            "(ROADMAP.md, Queue 1 'Generic model path'); ported: "
            f"{sorted(BLOCK_REGISTRY)}"
        )
    return BLOCK_REGISTRY[block_type](**kwargs)


class MILModel(nn.Module):
    """Encoder blocks -> pooling filter -> decoder blocks."""

    def __init__(self, model_config: Dict):
        super().__init__()
        self.model_config = model_config
        specs = [dict(spec) for spec in model_config["block"]]
        self.blocks = nn.ModuleList(build_block(spec.pop("block_type"), **spec) for spec in specs)
        self.pooling_index: Optional[int] = None
        for i, blk in enumerate(self.blocks):
            if isinstance(blk, _pooling.PoolingFilter):
                self.pooling_index = i
                break
        if self.pooling_index is None:
            raise ValueError("model config has no pooling filter")

    @property
    def encoder(self) -> List[nn.Module]:
        return list(self.blocks[: self.pooling_index])

    @property
    def pooling(self) -> _pooling.PoolingFilter:
        return self.blocks[self.pooling_index]

    @property
    def decoder(self) -> List[nn.Module]:
        return list(self.blocks[self.pooling_index + 1 :])

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

    def read_representation(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-read latent representation (reference: m6anet/model/model.py:85-97)."""
        return self._run(self.encoder, batch, False, None)

    def per_read_probability(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Flat per-read probabilities (N,) — the inference path
        (reference: m6anet/utils/inference_utils.py:35-37)."""
        return self.pooling.per_read_prob(self.read_representation(batch))

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
        x = self._run(self.encoder, batch, train, generator)
        y = self.pooling(x, train=train, generator=generator)
        return self._run(self.decoder, y, train, generator)

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
