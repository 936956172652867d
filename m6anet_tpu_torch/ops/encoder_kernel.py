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
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import span
from .fused_infer_kernel import (
    CheckedKmerIds,
    FusedParamsT,
    check_host_kmer_ids,
    check_precision,
    check_read_inputs,
    count_wide,
    kernel_lib,
    launch_error,
    launch_read_prob_tc,
)
# the kernel's parameter set: the packed image the fused step uses too
from .fused_infer_kernel import prepare_fused_params_t as prepare_fused_params
# the kernel's function in plain PyTorch (f32 matmuls), phase A's own
from .fused_infer_kernel import read_probability_plain as fused_read_probability_plain

# launches of phase A alone in this process
launch_count = 0


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
        device = features.device
        p = torch.empty(features.shape[0], dtype=torch.float32, device=device)
        if precision != "f32":
            launch_read_prob_tc(fp, features, kmer_ids, p, precision)
            launch_count += 1
            return p
        lib = kernel_lib(fp.widths, kmer_ids.element_size())
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            with span("ops.launch.read_prob"):
                err = lib.read_prob_launch(
                    features.data_ptr(), kmer_ids.data_ptr(), fp.packed.data_ptr(), p.data_ptr(),
                    features.shape[0], stream,
                )
        if err != 0:
            raise launch_error(lib, err)
        count_wide("f32", fp.widths, kmer_ids)
        launch_count += 1
        return p
