"""m6anet's production model (m6anet/model/configs/model_configs/m6anet.toml):
3 positions x 3 signal features, each position's 5-mer embedded in 2
values, concatenated (signal first) into 15 inputs, then 15 -> 150 (BN,
relu) -> 32 (relu) -> 1 (sigmoid)."""
from __future__ import annotations

import torch

from .mlp import MODES, encoder_p


def per_read_p(w, features: torch.Tensor, kmer_ids: torch.Tensor, mode: str) -> torch.Tensor:
    emb = w["block1/embedding"][kmer_ids.long()].reshape(features.shape[0], -1)
    x = torch.cat([features.to(MODES[mode]), emb], dim=1)
    return encoder_p(w, x, ("block3", "block4", "block5"), mode)
