"""Training engine: ``torch.optim.Adam`` training of the MIL model.

The port of the JAX package's ``train/loop.py`` (capability parity with the
reference training loop, reference: m6anet/utils/training_utils.py:61-268):
epoch loop with per-epoch validation, optional global-norm gradient
clipping, checkpointing every ``save_per_epoch`` epochs, and n-iteration
resampled validation averaging.

The JAX package's optax chain is global-norm clip -> ``add_decayed_weights``
-> ``scale_by_adam`` -> ``scale(-lr)``: torch-Adam semantics, weight decay
added to the clipped gradient before the moments.  Here that is
:func:`clip_by_global_norm_` (optax's formula) followed by
``torch.optim.Adam(weight_decay=...)``.

A step keeps its loss and predictions on the device: an epoch fetches them
once, at its end, and a validation pass its predictions once, so the host
never waits on the card between steps.
"""
from __future__ import annotations

import inspect
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.convert import jax_leaf_order
from ..models.pooling import PoolingFilter
from .metrics import get_pr_auc, get_roc_auc


def make_optimizer(model: torch.nn.Module, lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam over every parameter, with the JAX package's constants and
    classic L2 weight decay (the BatchNorm running statistics are buffers,
    never trained)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: the gradients unchanged when
    their global norm is below ``max_norm``, else ``g / norm * max_norm``.
    The norm is summed leaf by leaf in the order given, and the choice is
    made on the device (no host sync).  Not ``clip_grad_norm_``, which
    divides by ``norm + 1e-6``."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _loss_supports_mask(loss_fn: Callable) -> bool:
    try:
        return "mask" in inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False


def _site_probability(model, batch, data_parallel, **kwargs):
    """The model's site probabilities for the batch: on one process all of
    them; under ``data_parallel``, this rank's rows, gathered over ranks
    into the global batch's."""
    if data_parallel is None:
        return model.site_probability({"X": batch["X"], "kmer": batch["kmer"]}, **kwargs)
    x = {"X": data_parallel.shard(batch["X"]), "kmer": data_parallel.shard(batch["kmer"])}
    return data_parallel.gather(model.site_probability(x, **kwargs))


def set_data_parallel(model, data_parallel) -> None:
    """Point every train-mode ``Linear`` of the model at ``data_parallel``
    (``None``: one process)."""
    from ..models.blocks import Linear

    for module in model.modules():
        if isinstance(module, Linear):
            module.data_parallel = data_parallel


def make_train_step(
    model, loss_fn: Callable, optimizer: torch.optim.Optimizer, clip_grad: Optional[float] = None,
    data_parallel=None,
):
    """One train step on a batch of device tensors: train-mode forward (the
    BatchNorm running statistics refreshed in place), loss, gradients,
    global-norm clip, Adam update.  Returns the loss and the site
    probabilities, on the device.

    If the batch carries a ``mask`` (1.0 = real sample, 0.0 = wrap-around
    padding from TrainLoader's ``pad_to_multiple``) and the loss function
    accepts a ``mask`` kwarg, padded duplicates get zero loss weight;
    custom losses without mask support fall back to the full-batch
    reduction (metrics are always de-padded host-side).

    ``data_parallel`` (a ``parallel.group.DataParallel``) makes it the JAX
    package's mesh step over the ranks of a job: every rank is given the
    whole global batch, runs the model on its own rows, and takes the one
    step the global batch gives on one process (BatchNorm statistics,
    dropout, loss and gradients over the global batch; see
    ``DataParallel``).  The batch's rows must split evenly over the ranks."""
    supports_mask = _loss_supports_mask(loss_fn)
    params = dict(model.named_parameters())
    # the JAX parameter tree's leaf order, so the global norm sums as optax's
    ordered = [params[key] for _, key in jax_leaf_order(model) if key in params]
    set_data_parallel(model, data_parallel)

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        optimizer.zero_grad()
        pred = _site_probability(model, batch, data_parallel, train=True, generator=generator)
        mask = batch.get("mask") if supports_mask else None
        loss = loss_fn(pred, batch["y"]) if mask is None else loss_fn(pred, batch["y"], mask=mask)
        loss.backward()
        for p in ordered:
            # a parameter the site output does not reach (the read classifier
            # of ProbabilityAttention and SummaryStatsProbability) gets a zero
            # gradient, as under jax.grad: Adam then moves it by its weight
            # decay alone, as optax does
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if data_parallel is not None:
            data_parallel.sum_grads_([p.grad for p in ordered])
        if clip_grad is not None:
            clip_by_global_norm_([p.grad for p in ordered], clip_grad)
        optimizer.step()
        return loss.detach(), pred.detach()

    return step


def make_eval_step(model, loss_fn: Callable, data_parallel=None):
    """The eval-mode step; under ``data_parallel`` each rank runs its own
    rows of the batch and every rank gets the gathered predictions."""
    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]):
        pred = _site_probability(model, batch, data_parallel)
        return loss_fn(pred, batch["y"]), pred

    return step


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch as tensors on ``device``.  On the card each
    array is staged in pinned memory and copied asynchronously: a copy from
    pageable memory would make the host wait for the card."""
    out = {}
    for key, value in batch.items():
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        out[key] = tensor
    return out


def _fetch(losses, pred_parts) -> Tuple[np.ndarray, np.ndarray]:
    """ONE device concat + ONE host copy for a whole epoch or pass: the
    per-step losses, and the predictions with each batch cut back to its
    valid (un-padded) prefix."""
    parts = [torch.stack(losses)] if losses else []
    parts += [p.reshape(-1) for p, _ in pred_parts]
    flat = torch.cat(parts).cpu().numpy()
    n_loss = len(losses)
    sizes = [p.numel() for p, _ in pred_parts]
    bounds = np.cumsum([n_loss] + sizes)
    preds = np.concatenate([
        flat[bounds[j] : bounds[j] + (sizes[j] if nv is None else nv)]
        for j, (_, nv) in enumerate(pred_parts)
    ])
    return flat[:n_loss], preds


def run_epoch_steps(step, train_loader, generator, device):
    """The steps of one epoch, with nothing fetched from the device: the
    losses and ``(pred, n_valid)`` pairs stay there, with the labels of the
    valid rows on the host."""
    losses, pred_parts, y_true = [], [], []
    for batch in train_loader:
        batch = dict(batch)
        n_valid = batch.pop("n_valid", None)
        if n_valid is not None:
            # wrap-around padded rows (loader pad_to_multiple) get zero loss
            # weight; see make_train_step
            batch["mask"] = (np.arange(len(batch["y"])) < n_valid).astype(np.float32)
        loss, pred = step(batch_to_device(batch, device), generator)
        losses.append(loss)
        pred_parts.append((pred, n_valid))
        y_true.append(batch["y"][:n_valid])
    return losses, pred_parts, y_true


def train_one_epoch(step, train_loader, generator, device) -> Dict:
    """(reference: m6anet/utils/training_utils.py:148-210).  Dropout draws
    from ``generator``, which runs on across epochs."""
    start = time.time()
    losses, pred_parts, y_true = run_epoch_steps(step, train_loader, generator, device)
    losses, y_pred = _fetch(losses, pred_parts)
    y_true = np.concatenate(y_true)
    return {
        "compute_time": time.time() - start,
        "avg_loss": float(losses.mean()),
        "roc_auc": get_roc_auc(y_true, y_pred),
        "pr_auc": get_pr_auc(y_true, y_pred),
    }


def validate(eval_step, val_loader, loss_fn, device, n_iterations: int = 1) -> Dict:
    """n-pass resampled validation with prediction averaging
    (reference: m6anet/utils/training_utils.py:213-268; the loss is computed
    on the *averaged* predictions, as there, on the host)."""
    start = time.time()
    all_y_true = None
    all_preds = []
    for _ in range(n_iterations):
        y_true_pass, pred_parts = [], []
        for batch in val_loader:
            batch = dict(batch)
            n_valid = batch.pop("n_valid", None)
            _, pred = eval_step(batch_to_device(batch, device))
            if all_y_true is None:
                y_true_pass.append(batch["y"][:n_valid])
            pred_parts.append((pred, n_valid))
        if all_y_true is None:
            all_y_true = np.concatenate(y_true_pass)
        all_preds.append(_fetch([], pred_parts)[1])
    y_pred_avg = np.mean(all_preds, axis=0)
    return {
        "y_pred": all_preds,
        "y_true": all_y_true,
        "compute_time": time.time() - start,
        "roc_auc": get_roc_auc(all_y_true, y_pred_avg),
        "pr_auc": get_pr_auc(all_y_true, y_pred_avg),
        "avg_loss": float(loss_fn(torch.from_numpy(y_pred_avg), torch.from_numpy(all_y_true))),
    }


# The fresh-init fixed point (the JAX package's statistical-parity study,
# PERFORMANCE.md): on any fresh init of this architecture the per-read
# probabilities sit near 0.5, the 20-read noisy-OR saturates site_p at
# 1 - 0.5^20, and under the balanced sampler negative sites contribute
# -log(0.5^20) = 13.86 -> mean loss ~6.93 with ROC ~0.5.  Most runs escape
# it; ~1-in-6 seeds get their Adam second moment poisoned by the clamped
# backward's gradient spikes at the boundary and freeze there (the
# reference torch loop stalls the same way).
STALL_LOSS_RANGE = (5.5, 8.5)
STALL_ROC_RANGE = (0.35, 0.65)


def detect_stall(
    losses,
    rocs,
    patience: int = 20,
    loss_range: Tuple[float, float] = STALL_LOSS_RANGE,
    roc_range: Tuple[float, float] = STALL_ROC_RANGE,
) -> bool:
    """True when the last ``patience`` epochs all sit in the known plateau
    (loss near -log(0.5^20)/2 with chance-level train ROC — see the module
    constants).  Converging runs leave the loss window within a few epochs;
    requiring the FULL trailing window inside it keeps slow starters safe."""
    if patience <= 0 or len(losses) < patience:
        return False
    lo, hi = loss_range
    rlo, rhi = roc_range
    return all(
        lo <= ls <= hi and rlo <= rc <= rhi
        for ls, rc in zip(losses[-patience:], rocs[-patience:])
    )


def saturation_aware_init(model, bias: float = -4.0):
    """Opt-in alternative mitigation: set the probability layer's bias so a
    fresh init starts with per-read p ~ sigmoid(bias) and site_p well below
    1, outside the saturated noisy-OR region.  Changes the init
    distribution vs the reference torch loop, hence never the default.
    As in the JAX package, only a filter whose own parameters hold the
    bias (``b`` at the top of its tree: the instance-pooling filters) is
    touched; ``ProbabilityAttention``'s, under ``read_classifier``, is not."""
    with torch.no_grad():
        for blk in model.blocks:
            if isinstance(blk, PoolingFilter) and hasattr(blk, "linear"):
                blk.linear.bias.fill_(bias)
    return model


def _print_epoch(epoch, epoch_increment, n_epoch, tr, vr, total_time):
    print(
        f"Epoch:[{epoch + epoch_increment}/{n_epoch + epoch_increment}] \t "
        f"train time:{tr['compute_time']:.0f}s \t "
        f"val time:{vr['compute_time']:.0f}s \t ({total_time:.0f}s)"
    )
    print(
        f"Train Loss:{tr['avg_loss']:.2f}\t "
        f"Train ROC AUC: {tr['roc_auc']:.3f}\t Train PR AUC: {tr['pr_auc']:.3f}"
    )
    print(
        f"Val Loss:{vr['avg_loss']:.2f} \t "
        f"Val ROC AUC: {vr['roc_auc']:.3f}\t Val PR AUC: {vr['pr_auc']:.3f}"
    )
    print("=====================================")


def train(
    model,
    train_loader,
    val_loader,
    optimizer: torch.optim.Optimizer,
    n_epoch: int,
    loss_fn: Callable,
    save_dir: Optional[str] = None,
    clip_grad: Optional[float] = None,
    save_per_epoch: int = 10,
    epoch_increment: int = 0,
    n_iterations: int = 1,
    seed: int = 0,
    init_fn: Optional[Callable[[int], None]] = None,
    reseed_on_stall: bool = False,
    stall_patience: int = 20,
    max_restarts: int = 3,
    stall_loss_range: Tuple[float, float] = STALL_LOSS_RANGE,
    stall_roc_range: Tuple[float, float] = STALL_ROC_RANGE,
    data_parallel=None,
) -> Tuple[Dict, Dict]:
    """Full training run (reference: m6anet/utils/training_utils.py:61-145),
    on the device of the model's parameters.  Trains ``model`` in place and
    returns ``(train_results, val_results)``.

    To resume, restore the model and optimizer with
    :func:`m6anet_tpu_torch.train.checkpoint.restore_checkpoint` and pass
    the checkpoint's epoch as ``epoch_increment``.

    ``reseed_on_stall`` (off by default): when the run sits in the known
    saturated-noisy-OR plateau for ``stall_patience`` consecutive epochs
    (see :func:`detect_stall`), restart from scratch: ``init_fn(seed)``
    re-initialises the model in place with a seed derived from the attempt
    number, the optimizer's state is cleared, at most ``max_restarts``
    times.  The results returned are the final attempt's only.

    ``data_parallel`` trains over the ranks of a job (``make_train_step``):
    every rank iterates the same loaders, so the loaders must give every
    rank the same batches, padded to a multiple of the ranks; every rank
    gets the same metrics, rank 0 alone prints them and writes the
    checkpoints, and the ranks meet after each checkpoint.
    """
    if save_per_epoch > n_epoch:
        raise ValueError(f"save_per_epoch ({save_per_epoch}) exceeds the number of epochs ({n_epoch})")
    if reseed_on_stall and init_fn is None:
        raise ValueError("reseed_on_stall requires init_fn (a seed -> re-initialise the model)")

    step = make_train_step(model, loss_fn, optimizer, clip_grad, data_parallel)
    eval_step = make_eval_step(model, loss_fn, data_parallel)
    main_rank = data_parallel is None or data_parallel.rank == 0
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + epoch_increment)

    total_time = 0.0
    attempt = 0
    while True:  # one iteration per training attempt (restarts on stall)
        train_results: Dict = {}
        val_results: Dict = {}
        stalled = False

        for epoch in range(1, n_epoch + 1):
            tr = train_one_epoch(step, train_loader, generator, device)
            vr = validate(eval_step, val_loader, loss_fn, device, n_iterations)
            total_time += tr["compute_time"] + vr["compute_time"]

            if main_rank:
                _print_epoch(epoch, epoch_increment, n_epoch, tr, vr, total_time)

            for key, val in tr.items():
                train_results.setdefault(key, []).append(val)
            for key, val in vr.items():
                val_results.setdefault(key, []).append(val)

            if (
                reseed_on_stall
                and attempt < max_restarts
                and detect_stall(
                    train_results["avg_loss"], train_results["roc_auc"],
                    stall_patience, stall_loss_range, stall_roc_range,
                )
            ):
                stalled = True
                break

            if save_dir is not None and (epoch + epoch_increment) % save_per_epoch == 0:
                from .checkpoint import save_checkpoint

                if main_rank:
                    save_path = os.path.join(save_dir, "model_states", str(epoch + epoch_increment))
                    save_checkpoint(save_path, model, optimizer, epoch + epoch_increment)
                if data_parallel is not None:
                    data_parallel.barrier()  # the checkpoint is on disk for every rank

        if not stalled:
            return train_results, val_results

        attempt += 1
        derived = seed + 9973 * attempt  # deterministic, collision-free per attempt
        if main_rank:
            print(
                f"[stall] loss/ROC sat in the saturated noisy-OR plateau for "
                f"{stall_patience} epochs — restarting with derived seed {derived} "
                f"(attempt {attempt}/{max_restarts})"
            )
        init_fn(derived)
        optimizer.state.clear()
        generator.manual_seed(derived + epoch_increment)
