"""m6anet's production model (m6anet/model/configs/model_configs/m6anet.toml):
3 positions x 3 signal features, each position's 5-mer embedded in 2
values, concatenated (signal first) into 15 inputs, then 15 -> 150 (BN,
relu) -> 32 (relu) -> 1 (sigmoid).

In train mode (``train_site_p``) BatchNorm normalises by the batch's
mean and biased variance over every read of the batch, and refreshes its
running statistics with momentum 0.1 from the batch mean and the
unbiased variance (torch.nn.BatchNorm1d's definition); a site's
probability is the noisy-OR of its reads, ``1 - prod_r (1 - p_r)``."""
from __future__ import annotations

import torch

from .mlp import BN_EPS, MODES, encoder_p

BN_MOMENTUM = 0.1
STATS = ("block3/bn_mean", "block3/bn_var")  # running statistics: refreshed, never trained


def per_read_p(w, features: torch.Tensor, kmer_ids: torch.Tensor, mode: str) -> torch.Tensor:
    emb = w["block1/embedding"][kmer_ids.long()].reshape(features.shape[0], -1)
    x = torch.cat([features.to(MODES[mode]), emb], dim=1)
    return encoder_p(w, x, ("block3", "block4", "block5"), mode)


def train_site_p(w, X: torch.Tensor, kmer: torch.Tensor, matmul):
    """site_p (sites,) of a batch ``X`` (sites, reads, 9), ``kmer`` (sites,
    reads, 3) in train mode, and the refreshed running statistics."""
    sites, reads = X.shape[0], X.shape[1]
    n = sites * reads
    emb = w["block1/embedding"][kmer.reshape(n, -1).long()].reshape(n, -1)
    y = matmul(torch.cat([X.reshape(n, -1), emb], dim=1), w["block3/w"]) + w["block3/b"]
    mean = y.mean(dim=0)
    var = (y - mean).square().mean(dim=0)
    h = torch.relu((y - mean) / torch.sqrt(var + BN_EPS) * w["block3/bn_scale"] + w["block3/bn_bias"])
    h = torch.relu(matmul(h, w["block4/w"]) + w["block4/b"])
    p = torch.sigmoid(matmul(h, w["block5/w"]) + w["block5/b"]).reshape(sites, reads)
    stats = {
        "block3/bn_mean": (1 - BN_MOMENTUM) * w["block3/bn_mean"] + BN_MOMENTUM * mean.detach(),
        "block3/bn_var": (1 - BN_MOMENTUM) * w["block3/bn_var"] + BN_MOMENTUM * var.detach() * (n / (n - 1)),
    }
    return 1.0 - torch.prod(1.0 - p, dim=1), stats
