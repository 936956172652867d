"""The comparison that decides ``correct`` in a train cell: the program's
train steps against the plain reference's (``reference/train.py`` and the
configuration's ``train_site_p``) in float64, on the same staged batches.

Two stretches of steps are followed:

* the start: the program's first three steps in set-up, from the
  configuration's weights, each through the window's own call on its own
  batch; the reference follows them from the same weights with moments of
  zero;
* the last pass: the window's last 16 steps, one a staged batch, each
  from the state the window copied before it (parameters, running
  statistics, Adam's moments and step count).  The reference cannot
  follow the thousands of steps before it, nor the pass from its start:
  float32 and float64 trajectories part within a few steps (Adam's
  normalised step turns the gradient's rounding into steps of order lr
  wherever the second moment is small), and so do two float32 runs of
  the program on the card, whose reductions are not bit for bit
  repeatable.  So it makes each step from the program's own state before
  it; the start checks the steps from the weights on their own.

Five numbers, each held to its limit (``limits/<workload>.json``):

* ``loss_err``: the largest relative |loss - loss_ref| over the start's
  steps and each of the pass's;
* ``pred_err``: the largest |site_p - site_p_ref| over the site
  probabilities those steps returned;
* ``grad_gap``: the first step's gradient as Adam is given it (the
  program's worked out from its first moment after one step, ``m / (1 -
  b1)``), by the worst leaf: |‖g‖ - ‖g_ref‖| over the larger of the
  reference's ‖g_ref‖ of that leaf and of the median leaf;
* ``change_gap``: the change of the parameters and running statistics
  over the start, by the worst leaf in the same measure;
* ``step_change_gap``: their change in each of the pass's steps, by the
  worst leaf in the same measure.

A trained leaf whose reference gradient in a step is under a thousandth of
the median leaf's is left out of that step's change: its true gradient is
nought (the bias before a train-mode BatchNorm, which the batch mean
cancels), and Adam's normalised step turns rounding there into steps of
order lr on either side.  A running statistic is always compared: within
one step it follows the batch mean of the state both sides share.

A NaN reads as an infinite error.  The compared steps are the start's
three and the pass's sixteen; each carries its own loss and prediction
numbers, a pass step its own change, and the start's steps their
stretch's gradient and change (a number another stretch holds reads 0).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

from .check import reference_module
from .reference import train
from .reference.mlp import MODES

NAMES = ("loss_err", "pred_err", "grad_gap", "change_gap", "step_change_gap")
START_STEPS = 3
DEAD_LEAF = 1e-3  # a leaf's reference gradient norm under this share of the median leaf's: left out of a change


def tensors(flat: Dict, mode: str, device) -> Dict[str, torch.Tensor]:
    """Arrays or tensors as tensors of the mode's type on ``device``."""
    return {k: torch.as_tensor(v, dtype=MODES[mode], device=device) for k, v in flat.items()}


def state_of(record: Dict, mode: str, device) -> train.State:
    """A copied program state (``TrainCell``'s record) as the reference's."""
    return train.State(*(tensors(record[k], mode, device) for k in ("params", "stats", "m", "v")),
                       int(record["step"]))


def _finite(x: float) -> float:
    return math.inf if math.isnan(x) else x


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each of ``leaves``' |‖program‖ - ‖reference‖| / max(‖reference‖, the
    median leaf's ‖reference‖)."""
    norms = {k: _norm(reference[k]) for k in leaves}
    scale = statistics.median(norms.values())
    gaps = {}
    for k in leaves:
        gap = _finite(abs(_norm(program[k]) - norms[k]))
        den = max(norms[k], scale)
        gaps[k] = gap / den if den > 0 else (0.0 if gap == 0 else math.inf)
    return gaps


def _worst(gaps: Dict[str, float]):
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moved_leaves(ref, grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves a change is compared over: each trained leaf whose
    reference gradient is not nought to rounding, and every running
    statistic."""
    norms = {k: _norm(g) for k, g in grad.items()}
    floor = DEAD_LEAF * statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= floor] + list(ref.STATS)


def change(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor], leaves) -> Dict[str, torch.Tensor]:
    return {k: after[k].double() - before[k].double() for k in leaves}


def step_numbers(losses, preds, ref_steps: train.Steps) -> List[Dict[str, float]]:
    out = []
    for loss, pred, ref_loss, ref_pred in zip(losses, preds, ref_steps.losses, ref_steps.preds):
        out.append({
            "loss_err": _finite(abs(loss - ref_loss) / abs(ref_loss)),
            "pred_err": _finite(float(torch.max(torch.abs(pred.double() - ref_pred.double())))),
        })
    return out


def judge(config_name: str, weights, batches: Sequence[Dict[str, torch.Tensor]], start: Dict, last_pass: Dict,
          lr: float, weight_decay: float, device, control: bool = False, log=None) -> List[Dict[str, float]]:
    """Each compared step's numbers.  ``start``: the program's first
    ``START_STEPS`` steps (``losses``, ``preds``, ``first_m``: Adam's first
    moments after step 1, ``after``: parameters and statistics after the
    last); ``last_pass``: the window's last pass (``losses``, ``preds``,
    ``states``: the copied state before each step and after the last).
    With ``control`` the reference in TF32 takes the program's place in
    each compared step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = reference_module(config_name)
    w64 = tensors(weights, "f64", device)
    ref_start = train.train_steps(ref, train.start_state(ref, w64), batches[:START_STEPS], lr, weight_decay, "f64")
    if control:
        ctl = train.train_steps(ref, train.start_state(ref, tensors(weights, "tf32", device)),
                                batches[:START_STEPS], lr, weight_decay, "tf32")
        start = {"losses": ctl.losses, "preds": ctl.preds,
                 "first_m": {k: (1.0 - train.BETAS[0]) * g for k, g in ctl.first_grad.items()},
                 "after": dict(ctl.state.params, **ctl.state.stats)}
    first_grad = {k: m / (1.0 - train.BETAS[0]) for k, m in tensors(start["first_m"], "f64", device).items()}
    grad_gap, grad_leaf = _worst(leaf_gaps(first_grad, ref_start.first_grad, list(ref_start.first_grad)))
    moved = moved_leaves(ref, ref_start.first_grad)
    start_change, start_leaf = _worst(leaf_gaps(
        change(tensors(start["after"], "f64", device), w64, moved),
        change(dict(ref_start.state.params, **ref_start.state.stats), w64, moved), moved))
    numbers = [dict(n, grad_gap=grad_gap, change_gap=start_change, step_change_gap=0.0)
               for n in step_numbers(start["losses"], start["preds"], ref_start)]
    left_out = set(weights) - set(moved)

    states = last_pass["states"]
    worst_step = (0.0, None, None)
    for k, batch in enumerate(batches):
        before = state_of(states[k], "f64", device)
        ref_step = train.train_steps(ref, before, [batch], lr, weight_decay, "f64")
        loss, pred = last_pass["losses"][k], last_pass["preds"][k]
        after = tensors(dict(states[k + 1]["params"], **states[k + 1]["stats"]), "f64", device)
        if control:
            ctl = train.train_steps(ref, state_of(states[k], "tf32", device), [batch], lr, weight_decay, "tf32")
            loss, pred, after = ctl.losses[0], ctl.preds[0], dict(ctl.state.params, **ctl.state.stats)
        moved = moved_leaves(ref, ref_step.first_grad)
        before_flat = dict(before.params, **before.stats)
        gap, leaf = _worst(leaf_gaps(change(after, before_flat, moved),
                                     change(dict(ref_step.state.params, **ref_step.state.stats), before_flat, moved),
                                     moved))
        worst_step = max(worst_step, (gap, k, leaf), key=lambda x: x[0])
        left_out |= set(weights) - set(moved)
        numbers.append(dict(step_numbers([loss], [pred], ref_step)[0], grad_gap=0.0, change_gap=0.0,
                            step_change_gap=gap))
    if log is not None:
        log(f"train check: start grad_gap {grad_gap!r} ({grad_leaf}), change_gap {start_change!r} ({start_leaf}); "
            f"last pass: worst step_change_gap {worst_step[0]!r} (step {worst_step[1]}, {worst_step[2]}); "
            f"left out of a change: {sorted(left_out)}")
    return numbers
