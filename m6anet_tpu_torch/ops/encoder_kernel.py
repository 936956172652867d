"""Per-read modification probabilities of the production model, alone.

The port of ``fused_read_probability`` in the JAX package's
``ops/encoder_kernel.py``: the encoder forward (k-mer embedding, concat,
Linear 15->150 with eval BatchNorm folded in, ReLU, Linear 150->32, ReLU,
Linear 32->1, sigmoid) for every read of a batch, with no site statistics.

The JAX package folds the embedding into per-position (66, 150) tables for
its MXU; the port keeps one parameter layout for this function and the
fused step, the packed weight image of ``csrc/fused_infer.cu``, whose
phase A computes exactly this.  On a CUDA tensor
:func:`fused_read_probability` launches phase A alone through the kernel
file's ``read_prob_launch`` entry point and counts the launch in
``launch_count``; on a CPU tensor it runs
:func:`fused_read_probability_plain`.  There is no fallback from one to the
other.
"""
from __future__ import annotations

import torch

from .fused_infer_kernel import FusedParamsT, check_read_inputs, kernel_lib, launch_error
# the kernel's parameter set: the packed image the fused step uses too
from .fused_infer_kernel import prepare_fused_params_t as prepare_fused_params
# the kernel's function in plain PyTorch (f32 matmuls), phase A's own
from .fused_infer_kernel import read_probability_plain as fused_read_probability_plain

# launches of phase A alone in this process
launch_count = 0


def fused_read_probability(
    fp: FusedParamsT,
    features: torch.Tensor,  # (N, 9) f32
    kmer_ids: torch.Tensor,  # (N, 3) int8 or int32
) -> torch.Tensor:
    """Per-read probabilities p (N,).  CPU tensors run the plain version;
    CUDA tensors launch phase A of the fused kernel.  int32 k-mer ids are
    checked and narrowed to the int8 the kernel reads."""
    global launch_count
    if features.device.type == "cpu":
        return fused_read_probability_plain(fp, features, kmer_ids)
    kmer_ids = check_read_inputs(fp, features, kmer_ids, "fused_read_probability")
    lib = kernel_lib()
    device = features.device
    p = torch.empty(features.shape[0], dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.read_prob_launch(
            features.data_ptr(), kmer_ids.data_ptr(), fp.packed.data_ptr(), p.data_ptr(),
            features.shape[0], stream,
        )
    if err != 0:
        raise launch_error(lib, err)
    launch_count += 1
    return p
