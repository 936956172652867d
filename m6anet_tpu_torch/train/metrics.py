"""Evaluation metrics (reference: m6anet/utils/training_utils.py:15-58) in
numpy.

The JAX package computes them with scikit-learn (``roc_curve`` + ``auc``,
``precision_recall_curve`` + ``auc``, ``accuracy_score``); the port
computes the same curves the same way, ties included, and needs no
scikit-learn.  Binary labels, 1 the positive class.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _curve_counts(y_true: np.ndarray, y_score: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """False and true positives at each distinct score, highest first:
    sklearn's ``confusion_matrix_at_thresholds`` (a stable sort by
    descending score, one threshold where the sorted score changes and one
    at the end, counts as float64 cumulative sums)."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    idx = np.r_[np.flatnonzero(np.diff(y_score)), y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under y(x) for monotonic x, as sklearn's ``auc``."""
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
        direction = -1.0
    return float(direction * np.add.reduce(dx * (y[1:] + y[:-1]) / 2.0))


def get_roc_auc(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    fps, tps = _curve_counts(y_true, y_pred)
    if fps.size > 2:  # drop collinear points, as roc_curve(drop_intermediate=True)
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    # one class only: sklearn warns and the rate is undefined (nan)
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return _auc(fpr, tpr)


def get_pr_auc(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    fps, tps = _curve_counts(y_true, y_pred)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    return _auc(np.r_[recall[::-1], 0.0], np.r_[precision[::-1], 1.0])


def get_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(y_true).reshape(-1) == np.asarray(y_pred).reshape(-1)))
