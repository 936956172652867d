"""The read encoder both configurations share: Linear -> eval BatchNorm ->
relu -> Linear -> relu -> Linear(., 1) -> sigmoid, from weight arrays in
the JAX package's tree layout (``block<i>/w`` stored (in, out))."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BN_EPS = 1e-5
MODES = {"f64": torch.float64, "tf32": torch.float32}


def tensors(weights: Dict[str, np.ndarray], mode: str, device) -> Dict[str, torch.Tensor]:
    """The weight arrays as tensors of the mode's type on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=MODES[mode], device=device) for k, v in weights.items()}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as the card converts a product's operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def encoder_p(w: Dict[str, torch.Tensor], x: torch.Tensor, blocks, mode: str) -> torch.Tensor:
    """p (N,) of the reads ``x`` (N, n_in) through the Linear blocks named
    ``blocks`` (first with BatchNorm, second without, then the pooling
    filter's probability layer)."""
    first, second, head = blocks
    y = matmul(x, w[f"{first}/w"], mode) + w[f"{first}/b"]
    y = (y - w[f"{first}/bn_mean"]) / torch.sqrt(w[f"{first}/bn_var"] + BN_EPS) * w[f"{first}/bn_scale"]
    h = torch.relu(y + w[f"{first}/bn_bias"])
    h = torch.relu(matmul(h, w[f"{second}/w"], mode) + w[f"{second}/b"])
    return torch.sigmoid(matmul(h, w[f"{head}/w"], mode) + w[f"{head}/b"]).reshape(-1)
