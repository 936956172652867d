"""Per-read modification probabilities of the production model, alone.

The port of ``fused_read_probability`` in the JAX package's
``ops/encoder_kernel.py``: the encoder forward (k-mer embedding, concat,
Linear n_in->H1 with eval BatchNorm folded in, ReLU, Linear H1->H2, ReLU,
Linear H2->1, sigmoid; 15 -> 150 -> 32 in the released models, any widths
but those ``fused_infer_kernel.kernel_limit`` names) for every read of a
batch, with no site statistics.

The JAX package folds the embedding into per-position (66, 150) tables for
its MXU; the port keeps one parameter layout for this function and the
fused step, the packed weight image of ``csrc/fused_infer.cu``, whose
phase A computes exactly this.  On a CUDA tensor
:func:`fused_read_probability` launches phase A alone — through the kernel
file's ``read_prob_launch`` entry point in f32, or the tensor-core kernel
of ``csrc/read_prob_tc.cu`` in the reduced modes ``f32x3`` and ``bf16``
(with ``fused_inference_t``'s arithmetic, not the JAX function's own
split, which also takes layer 1 in f32x3 and contracts premultiplied
tables) — and counts the launch in ``launch_count``; on a CPU tensor it
runs :func:`fused_read_probability_plain`.  There is no fallback from one
to the other.  ``host_kmer_ids`` takes the host check of the k-mer ids,
as ``fused_infer_kernel.fused_inference_t`` does.

The same phase A, built with no k-mer input (``tail_defines``), is the
torch backend's per-read tail on the card (:func:`tail_read_probability`):
for a model of any block types whose encoder ends in two ``Linear`` blocks
with relu (eval BatchNorm optional on each) and whose pooling filter's
per-read probability layer is a sigmoid ``Linear(C, 1)``
(:func:`tail_blocks`), it runs the blocks before that tail as PyTorch
modules and the tail in one launch (:func:`read_prob_tail`), counted in
``tail_launch_count``.  The weights are folded and packed once
(:func:`prepare_tail_params`) in the kernel file's f32 image with no
embedding table.  The tail takes the kernel file's fast plan: widths the
file plans wide (its ``read_prob_wide``), and every model on the CPU, run
the modules (:func:`tail_params`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..models.blocks import Linear
from ..models.pooling import InstanceBasedPooling
from ..utils.profiling import span
from . import _native
from .fused_infer_kernel import (
    CheckedKmerIds,
    FusedParamsT,
    check_host_kmer_ids,
    check_precision,
    check_read_inputs,
    check_tensor,
    count_grouped,
    count_wide,
    kernel_lib,
    launch_read_prob_tc,
    pack_f32,
)
# the kernel's parameter set: the packed image the fused step uses too
from .fused_infer_kernel import prepare_fused_params_t as prepare_fused_params
# the kernel's function in plain PyTorch (f32 matmuls), phase A's own
from .fused_infer_kernel import read_probability_plain as fused_read_probability_plain

# launches of phase A alone in this process
launch_count = 0
# launches of the torch backend's per-read tail in this process
tail_launch_count = 0


def fused_read_probability(
    fp: FusedParamsT,
    features: torch.Tensor,  # (N, 3P) f32
    kmer_ids: torch.Tensor,  # (N, P) int8, int16 or int32
    precision: str = "f32",
    host_kmer_ids: Optional[CheckedKmerIds] = None,
) -> torch.Tensor:
    """Per-read probabilities p (N,) in ``precision``.  CPU tensors run the
    plain version; CUDA tensors launch phase A of the fused kernel (f32) or
    the tensor-core kernel (f32x3, bf16).  Wider k-mer ids are checked and
    narrowed to the int8 the kernels read, or int16 where an id is 128 or
    more.  ``host_kmer_ids``
    (``checked_kmer_ids`` of the array ``kmer_ids`` was copied from)
    replaces the check on the device, and its host sync."""
    global launch_count
    with span("ops.fused_read_probability"):
        check_precision(precision)
        if features.device.type == "cpu":
            if host_kmer_ids is not None:
                with span("ops.check"):
                    check_host_kmer_ids(host_kmer_ids, kmer_ids, fp.widths.vocab)
            return fused_read_probability_plain(fp, features, kmer_ids, precision)
        with span("ops.check"):
            kmer_ids = check_read_inputs(fp, features, kmer_ids, "fused_read_probability",
                                         host_kmer_ids=host_kmer_ids, precision=precision)
        p = torch.empty(features.shape[0], dtype=torch.float32, device=features.device)
        if precision != "f32":
            launch_read_prob_tc(fp, features, kmer_ids, p, precision)
        else:
            lib = kernel_lib(fp.widths, kmer_ids.element_size())
            _native.launch(lib, "read_prob_launch", "ops.launch.read_prob", features.device, features.data_ptr(),
                           kmer_ids.data_ptr(), fp.packed.data_ptr(), p.data_ptr(), features.shape[0])
            count_wide(lib, "f32", features.shape[0])
            count_grouped(lib, features.shape[0])
        launch_count += 1
        return p


class TailWidths(NamedTuple):
    """The widths of a per-read tail: Linear(n_in -> hidden1), Linear(hidden1
    -> hidden2), then the probability layer Linear(hidden2 -> 1).  ``emb``
    and ``vocab`` are 0, so ``fused_infer_kernel.f32_layout`` gives the
    image of the kernel built with :func:`tail_defines`: no embedding
    table."""

    n_in: int
    hidden1: int
    hidden2: int
    emb: int = 0
    vocab: int = 0


class TailParams(NamedTuple):
    """A model split for the kernel: ``head``, the blocks before the tail,
    run as modules; the tail as the kernel reads it, the f32 image of
    ``f32_layout(widths)`` with eval BatchNorm folded into both layers."""

    head: Tuple[nn.Module, ...]
    widths: TailWidths
    packed: torch.Tensor


def tail_blocks(model: nn.Module) -> Optional[Tuple[Linear, Linear, nn.Linear]]:
    """The two ``Linear`` blocks that end ``model``'s encoder and its
    filter's per-read probability layer, where the kernel computes that
    tail: both blocks relu, eval BatchNorm optional on each; the layer an
    ``InstanceBasedPooling``'s (``SigmoidProd/Mean/MaxPooling``, or the
    read classifier of ``ProbabilityAttention`` and
    ``SummaryStatsProbability``); every weight float32; widths that chain.
    None for any other model."""
    encoder, pool = model.encoder, model.pooling
    if pool is None or len(encoder) < 2:
        return None
    l1, l2 = encoder[-2:]
    head = getattr(pool, "read_classifier", pool)
    if not (isinstance(l1, Linear) and isinstance(l2, Linear) and isinstance(head, InstanceBasedPooling)):
        return None
    if l1.activation_name != "relu" or l2.activation_name != "relu":
        return None
    blocks = (l1, l2, head.linear)
    if any(t.dtype != torch.float32 for blk in blocks for t in blk.state_dict().values() if t.is_floating_point()):
        return None
    w1, w2, w3 = l1.linear.weight, l2.linear.weight, head.linear.weight
    if w2.shape[1] != w1.shape[0] or w3.shape != (1, w2.shape[0]):
        return None
    return blocks


def prepare_tail_params(model: nn.Module) -> Optional[TailParams]:
    """``model`` split at its tail (:func:`tail_blocks`), the tail folded
    and packed for the kernel, on the model's device, once: the step built
    with it holds the model's weights as they are now.  None where the
    model has no such tail."""
    blocks = tail_blocks(model)
    if blocks is None:
        return None
    l1, l2, head = blocks
    with torch.no_grad():
        (w1, b1), (w2, b2) = l1.folded(), l2.folded()
        widths = TailWidths(w1.shape[1], w1.shape[0], w2.shape[0])
        packed = pack_f32(widths, w1, w1.new_zeros(0, 0), b1[:, None], w2, b2[:, None], head.weight, head.bias[:, None])
    return TailParams(tuple(model.encoder[:-2]), widths, packed)


def tail_params(model: nn.Module) -> Optional[TailParams]:
    """:func:`prepare_tail_params` for a model on a card whose tail the
    kernel file plans fast (built here if needed); None on the CPU, where
    the torch step runs the modules, and for widths the file plans wide."""
    first = next(model.parameters(), None)
    if first is None or first.device.type != "cuda":
        return None
    tp = prepare_tail_params(model)
    return None if tp is None or tail_lib(tp.widths).plan["f32"]["wide"] else tp


def tail_defines(w: TailWidths) -> Dict[str, int]:
    """The ``-D`` defines that build csrc/fused_infer.cu's phase A as the
    tail of widths ``w``: no k-mer position, no embedding, ``n_in``
    inputs a read straight from its features."""
    return {"M6A_POS": 0, "M6A_EMB": 0, "M6A_VOCAB": 0, "M6A_TAIL_IN": w.n_in, "M6A_H1": w.hidden1,
            "M6A_H2": w.hidden2}


def tail_lib(w: TailWidths) -> _native.Library:
    """csrc/fused_infer.cu built as the tail of widths ``w``, loaded once
    (``_native.library``)."""
    return _native.library("fused_infer", tail_defines(w))


def read_prob_tail(tp: TailParams, x: torch.Tensor) -> torch.Tensor:
    """Per-read probabilities p (N,) of the tail ``tp`` over ``x`` (N,
    n_in), float32 and contiguous on the card: the output of the blocks
    before the tail.  One launch of the kernel's phase A, with no host
    sync."""
    global tail_launch_count
    with span("ops.read_prob_tail"):
        device, n = x.device, x.shape[0]
        with span("ops.check"):
            if device.type != "cuda":
                raise ValueError(f"read_prob_tail runs on cuda, got {device}")
            check_tensor("x", x, (torch.float32,), (n, tp.widths.n_in), device)
            if tp.packed.device != device:
                raise ValueError(f"the tail's weights are on {tp.packed.device}, x on {device}")
        lib = tail_lib(tp.widths)
        p = torch.empty(n, dtype=torch.float32, device=device)
        _native.launch(lib, "read_prob_launch", "ops.launch.read_prob_f32", device, x.data_ptr(), None,
                       tp.packed.data_ptr(), p.data_ptr(), n)
        count_grouped(lib, n)
        tail_launch_count += 1
        return p


def tail_read_probability(tp: TailParams, batch) -> torch.Tensor:
    """The model's per-read probabilities (N,) of ``batch``: ``tp.head``'s
    blocks as modules, then the tail in one launch (:func:`read_prob_tail`)."""
    x = batch
    for blk in tp.head:
        x = blk(x)
    return read_prob_tail(tp, x.reshape(-1, tp.widths.n_in).contiguous())
