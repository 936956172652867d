"""Training steps in plain PyTorch: a configuration's train-mode forward
(``<config>.train_site_p``), the binary cross-entropy of torch's
``BCELoss``, its gradient by autograd, and Adam, each written out from
its published definition.

* BCE per site: ``-(y log p + (1 - y) log(1 - p))`` with each log term
  clamped at -100, and the gradient ``(p - y) / max(p (1 - p), 1e-12)``
  (``BCELoss``' own backward, finite where p is exactly 0 or 1), reduced
  as the batch's mask weights it: ``sum(e m) / sum(m)``.
* Adam (Kingma and Ba, with torch's ``Adam`` conventions): the L2 decay
  added to the gradient, ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
  g^2``, ``theta -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``,
  betas (0.9, 0.999), eps 1e-8.

A configuration's module names its running statistics (``STATS``): they
are state the forward refreshes, never trained.  ``"f64"`` computes in
float64; ``"tf32"``, the control, in float32 with the operands of every
matrix product rounded to TF32, in the backward's products too.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from .mlp import MODES, tf32_round

BETAS = (0.9, 0.999)
EPS = 1e-8
LOG_FLOOR = -100.0
BCE_GRAD_FLOOR = float(torch.tensor(1e-12, dtype=torch.float32))  # BCELoss holds its 1e-12 as a float32


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = tf32_round(grad)
        return grad @ tf32_round(b).T, tf32_round(a).T @ grad


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b``, differentiable, in the mode's precision."""
    return _TF32Matmul.apply(a, b) if mode == "tf32" else a @ b


class _BCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, y):
        ctx.save_for_backward(p, y)
        log_p = torch.clamp(torch.log(p), min=LOG_FLOOR)
        log_q = torch.clamp(torch.log(1.0 - p), min=LOG_FLOOR)
        return -(y * log_p + (1.0 - y) * log_q)

    @staticmethod
    def backward(ctx, grad):
        p, y = ctx.saved_tensors
        return grad * (p - y) / torch.clamp(p * (1.0 - p), min=BCE_GRAD_FLOOR), None


def bce(site_p: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(site_p.dtype)
    return (_BCE.apply(site_p, y.to(site_p.dtype)) * m).sum() / m.sum()


class State(NamedTuple):
    """A training state in the configuration's weight layout: the trained
    leaves, the running statistics, Adam's moments (one a trained leaf)
    and its step count."""

    params: Dict[str, torch.Tensor]
    stats: Dict[str, torch.Tensor]
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int


class Steps(NamedTuple):
    losses: List[float]
    preds: List[torch.Tensor]  # each step's site_p
    first_grad: Dict[str, torch.Tensor]  # the first step's gradient, as Adam is given it
    state: State  # after the last step


def start_state(ref, weights: Dict[str, torch.Tensor]) -> State:
    """The state before a first step: the weights, moments of zero."""
    params = {k: t for k, t in weights.items() if k not in ref.STATS}
    zeros = {k: torch.zeros_like(t) for k, t in params.items()}
    return State(params, {k: weights[k] for k in ref.STATS}, zeros, dict(zeros), 0)


def adam_(state: State, grads: Dict[str, torch.Tensor], lr: float, weight_decay: float) -> State:
    b1, b2 = BETAS
    t = state.step + 1
    params, m, v = {}, {}, {}
    for k, theta in state.params.items():
        g = grads[k] + weight_decay * theta
        m[k] = b1 * state.m[k] + (1.0 - b1) * g
        v[k] = b2 * state.v[k] + (1.0 - b2) * g * g
        params[k] = theta - lr * (m[k] / (1.0 - b1**t)) / (torch.sqrt(v[k] / (1.0 - b2**t)) + EPS)
    return State(params, state.stats, m, v, t)


def train_steps(ref, state: State, batches, lr: float, weight_decay: float, mode: str) -> Steps:
    """``len(batches)`` train steps of the configuration ``ref`` from
    ``state`` (its tensors in the mode's type), one batch ``{"X", "kmer",
    "y", "mask"}`` a step."""
    losses, preds, first_grad = [], [], None
    for batch in batches:
        leaves = {k: t.detach().requires_grad_() for k, t in state.params.items()}
        site_p, stats = ref.train_site_p(dict(leaves, **state.stats), batch["X"].to(MODES[mode]), batch["kmer"],
                                         lambda a, b: matmul(a, b, mode))
        loss = bce(site_p, batch["y"], batch["mask"])
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(t) if g is None else g for (k, t), g in zip(leaves.items(), grads)}
        if first_grad is None:
            first_grad = {k: g + weight_decay * state.params[k] for k, g in grads.items()}
        losses.append(float(loss.detach()))
        preds.append(site_p.detach())
        state = adam_(state._replace(stats=stats), grads, lr, weight_decay)
    return Steps(losses, preds, first_grad, state)
