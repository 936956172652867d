"""Faults planted under a train cell's timed path, each of which the
comparison has to read as not correct (``portbench/tests/`` drives them on
the CPU; ``calibrate.py --faults`` reads them at the cell's own size).
Each is a ``wrap_step(step, program)`` for ``TrainCell``, ``program``
holding the model and the optimizer the step trains."""
from __future__ import annotations


def skipped(step, program):
    """The optimizer's update skipped: the state is returned unchanged."""
    program.optimizer.step = lambda closure=None: None
    return step


def skipped_late(step, program):
    """The optimizer's update skipped from the fourth call on: the start's
    three steps are sound, and every later step returns its state
    unchanged."""
    update, calls = program.optimizer.step, [0]

    def broken(closure=None):
        calls[0] += 1
        return update(closure) if calls[0] <= 3 else None

    program.optimizer.step = broken
    return step


def stale(step, program):
    """Batch 0's data used for every batch."""
    first = []

    def broken(batch, generator=None):
        if not first:
            first.append(batch)
        return step(first[0], generator)

    return broken


def detached(step, program):
    """The first ``Linear`` block's output detached: it and the blocks
    before it get no gradient."""
    from m6anet_tpu_torch.models.blocks import Linear

    first = next(m for m in program.model.blocks if isinstance(m, Linear))
    first.register_forward_hook(lambda module, inputs, output: output.detach())
    return step


def half(step, program):
    """Half of the batch left out: the loss the mean over its first half of
    sites (the loss's own mask)."""

    def broken(batch, generator=None):
        mask = batch["mask"].clone()
        mask[mask.shape[0] // 2 :] = 0.0
        return step(dict(batch, mask=mask), generator)

    return broken


def altered(which, by):
    """One answer changed where it is produced: the loss (0) scaled by
    ``1 + by``, or one site's probability (1) moved by ``by``."""

    def wrap(step, program):
        def broken(batch, generator=None):
            loss, pred = step(batch, generator)
            if which == 0:
                return loss * (1.0 + by), pred
            pred = pred.clone()
            pred[5] += by
            return loss, pred

        return broken

    return wrap


FAULTS = {"skipped": skipped, "skipped_late": skipped_late, "stale": stale, "detached": detached, "half": half,
          "loss": altered(0, 1e-3), "pred": altered(1, 0.01)}
