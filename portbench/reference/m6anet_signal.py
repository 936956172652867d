"""m6anet's signal-only model (m6anet/model/configs/model_configs/prod_pooling_signal.toml):
the 9 signal features of a read's 3 positions, no k-mer, then 9 -> 150
(BN, relu) -> 32 (relu) -> 1 (sigmoid)."""
from __future__ import annotations

import torch

from .mlp import MODES, encoder_p


def per_read_p(w, features: torch.Tensor, kmer_ids: torch.Tensor, mode: str) -> torch.Tensor:
    return encoder_p(w, features.to(MODES[mode]), ("block2", "block3", "block4"), mode)
