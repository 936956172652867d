"""Loss functions (reference: m6anet/utils/loss_functions/loss_functions.py),
the port of the JAX package's ``train/losses.py``.

Registered by name for the TOML ``[loss_function]`` contract
(reference: m6anet/utils/builder.py:93-110).

``F.binary_cross_entropy`` is torch's BCELoss, whose semantics the JAX
package imitates with a ``custom_vjp``: each log term clamped at -100, and
the backward ``(p - y) / max(p (1 - p), 1e-12)``, huge but finite where the
noisy-OR saturates the site probability at exactly 0 or 1.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def _bce_elementwise(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    p = y_pred.reshape(-1)
    return F.binary_cross_entropy(p, y_true.reshape(-1).to(p.dtype), reduction="none")


def _reduce(e: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return e.mean()
    m = mask.reshape(-1).to(e.dtype)
    return (e * m).sum() / m.sum().clamp(min=1.0)


def binary_cross_entropy_loss(y_pred, y_true, mask=None):
    """Plain BCE on probabilities (reference: loss_functions.py:8-20).

    ``mask`` (same length as the batch, 1.0 = real sample, 0.0 = padding)
    turns the reduction into a masked mean so wrap-around padded duplicates
    in the final batch of an epoch carry zero loss weight."""
    return _reduce(_bce_elementwise(y_pred, y_true), mask)


def weighted_binary_cross_entropy_loss(y_pred, y_true, mask=None):
    """Inverse-class-frequency weighted BCE: label-0 samples weighted by the
    positive count and label-1 samples by the negative count
    (reference: loss_functions.py:23-39).  ``mask`` excludes padded rows
    from both the class counts and the reduction.  A single-class batch
    (all weights zero; the reference crashes there) falls back to plain
    BCE, decided on the device, without a host sync."""
    y = y_true.reshape(-1).to(y_pred.dtype)
    m = None if mask is None else mask.reshape(-1).to(y_pred.dtype)
    n_pos = (y if m is None else y * m).sum()
    n_neg = (y.numel() if m is None else m.sum()) - n_pos
    weights = torch.where(y == 0, n_pos, n_neg)
    degenerate = (n_pos == 0) | (n_neg == 0)
    weights = torch.where(degenerate, torch.ones_like(weights), weights)
    return _reduce(_bce_elementwise(y_pred, y_true) * weights, m)


LOSS_REGISTRY = {
    "binary_cross_entropy_loss": binary_cross_entropy_loss,
    "weighted_binary_cross_entropy_loss": weighted_binary_cross_entropy_loss,
}


def build_loss_function(config: dict):
    """Resolve ``loss_function_type`` (+ extra kwargs) from a train config
    (reference: m6anet/utils/builder.py:93-110)."""
    config = dict(config)
    if "loss_function_type" not in config:
        raise ValueError("Config must specify loss_function_type")
    name = config.pop("loss_function_type")
    if name not in LOSS_REGISTRY:
        raise ValueError(f"Unknown loss function {name!r}; available: {sorted(LOSS_REGISTRY)}")
    fn = LOSS_REGISTRY[name]
    return functools.partial(fn, **config) if config else fn
