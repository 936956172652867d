"""Single-launch inference step: per-read encoder + per-site aggregation.

The port of ``fused_inference_t`` in the JAX package's
``ops/fused_infer_kernel.py``: one call gives the per-read probabilities
``p``, the closed-form noisy-OR site probabilities and the mod_ratios of a
``pack_sites`` batch (the two hot boxes of the reference's inference stack —
reference: m6anet/utils/inference_utils.py:35-53).

On a CUDA tensor :func:`fused_inference_t` launches the hand-written Hopper
kernel in ``csrc/fused_infer.cu`` (built at first use by ``_build.py``) and
counts the launch in ``launch_count``; on a CPU tensor it runs
:func:`fused_inference_t_plain`, the same function in plain PyTorch.  There
is no fallback from one to the other.  The kernel file's header states its
bound on the card and its design.

:func:`fused_inference` is the port of the JAX package's older
``fused_inference`` (the same contract given per-read site ids in the dense
``pack_sites`` layout): it launches the same kernel and counts its launches
apart, in ``fused_inference_launch_count``.  The engine does not call it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.blocks import BN_EPS, KmerMultipleEmbedding, Linear
from . import site_ops

# launches of the CUDA kernel in this process, by wrapper: one per
# fused_inference_t / fused_inference call on CUDA tensors
launch_count = 0
fused_inference_launch_count = 0

N_FEATURES, N_POSITIONS, VOCAB, EMB_DIM, HIDDEN1, HIDDEN2 = 9, 3, 66, 2, 150, 32
PACKED_WEIGHTS = 7400  # float count of the kernel's weight image (see the .cu)


class FusedParamsT(NamedTuple):
    """Transposed parameter set (the JAX package's ``FusedEncoderParamsT``)
    plus the packed weight image the CUDA kernel stages in shared memory."""

    w1t: torch.Tensor  # (150, 15) BN-folded first linear
    embt: torch.Tensor  # (2, 66) embedding, transposed
    b1t: torch.Tensor  # (150, 1)
    w2t: torch.Tensor  # (32, 150)
    b2t: torch.Tensor  # (32, 1)
    w3t: torch.Tensor  # (1, 32)
    b3t: torch.Tensor  # (1, 1)
    packed: torch.Tensor  # (7400,) f32, layout documented in csrc/fused_infer.cu


def _pack(w1t, embt, b1t, w2t, b2t, w3t, b3t) -> torch.Tensor:
    parts = [
        torch.cat([w1t, b1t], dim=1).reshape(-1),  # W1B [150][16]
        embt.t().reshape(-1),  # EMB [66][2]
        w2t.t().reshape(-1),  # W2 [150][32]
        b2t.reshape(-1),
        w3t.reshape(-1),
        b3t.reshape(-1),
    ]
    flat = torch.cat(parts)
    return torch.cat([flat, flat.new_zeros(PACKED_WEIGHTS - flat.numel())]).contiguous()


def prepare_fused_params_t(model: nn.Module) -> FusedParamsT:
    """Fold eval BatchNorm into the first linear layer and lay the weights
    out for the kernel, on the model's device.  The model must have the
    production architecture (``engine.fused_backend_supported``)."""
    blocks = list(model.blocks)
    emb = next(b for b in blocks if isinstance(b, KmerMultipleEmbedding)).embedding.weight
    l1, l2 = [b for b in blocks if isinstance(b, Linear)]
    head = model.pooling.linear

    def f32(t: torch.Tensor) -> torch.Tensor:  # a copy, detached from the model
        return t.detach().float().clone()

    w1, b1 = f32(l1.linear.weight), f32(l1.linear.bias)  # (150, 15), (150,)
    if l1.bn is not None:
        bn = l1.bn
        scale = f32(bn.weight) / torch.sqrt(f32(bn.running_var) + BN_EPS)
        w1 = w1 * scale[:, None]
        b1 = (b1 - f32(bn.running_mean)) * scale + f32(bn.bias)
    tensors = dict(
        w1t=w1.contiguous(),
        embt=f32(emb).t().contiguous(),
        b1t=b1[:, None].contiguous(),
        w2t=f32(l2.linear.weight),
        b2t=f32(l2.linear.bias)[:, None].contiguous(),
        w3t=f32(head.weight),
        b3t=f32(head.bias)[:, None].contiguous(),
    )
    expected = dict(
        w1t=(HIDDEN1, N_FEATURES + N_POSITIONS * EMB_DIM), embt=(EMB_DIM, VOCAB),
        b1t=(HIDDEN1, 1), w2t=(HIDDEN2, HIDDEN1), b2t=(HIDDEN2, 1), w3t=(1, HIDDEN2), b3t=(1, 1),
    )
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"fused kernel expects {name} of shape {shape}, got {tuple(tensors[name].shape)}")
    return FusedParamsT(**tensors, packed=_pack(**tensors))


def read_probability_plain(
    fp: FusedParamsT, features: torch.Tensor, kmer_ids: torch.Tensor
) -> torch.Tensor:
    """Phase A's function in plain PyTorch: per-read p (N,) (f32 matmuls)."""
    _check_kmer_range(kmer_ids)
    n = features.shape[0]
    emb = fp.embt.t()[kmer_ids.long()].reshape(n, -1)
    x = torch.cat([features, emb], dim=1)
    h = torch.relu(torch.matmul(x, fp.w1t.t()) + fp.b1t.t())
    h = torch.relu(torch.matmul(h, fp.w2t.t()) + fp.b2t.t())
    return torch.sigmoid(torch.matmul(h, fp.w3t.t()) + fp.b3t.t()).reshape(-1)


def fused_inference_t_plain(
    fp: FusedParamsT,
    features: torch.Tensor,
    kmer_ids: torch.Tensor,
    site_ids: Optional[torch.Tensor],
    offsets: torch.Tensor,
    counts: torch.Tensor,
    threshold: float,
    n_samples: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (f32 matmuls, f64 site sums)."""
    n, n_sites = features.shape[0], counts.shape[0]
    if site_ids is None:
        site_ids = site_ops.derive_site_ids(offsets, counts, n, n_sites)
    p = read_probability_plain(fp, features, kmer_ids)
    site_p = site_ops.site_probability_exact(p, site_ids, counts, n_sites, n_samples)
    mod_ratio = site_ops.mod_ratio_exact(p, site_ids, counts, n_sites, threshold)
    return p, site_p, mod_ratio


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ._build import cuda_library

            lib = ctypes.CDLL(cuda_library("fused_infer"))
            lib.fused_infer_launch.restype = ctypes.c_int
            lib.fused_infer_launch.argtypes = (
                [ctypes.c_void_p] * 8
                + [ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            lib.read_prob_launch.restype = ctypes.c_int
            lib.read_prob_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
            lib.read_prob_tile_reads.restype = ctypes.c_int
            lib.read_prob_tile_reads.argtypes = []
            lib.fused_infer_error_string.restype = ctypes.c_char_p
            lib.fused_infer_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def read_tile_reads() -> int:
    """Reads one block of the kernel's phase A takes per tile (threads per
    block x reads per thread); builds the kernel if needed."""
    return int(kernel_lib().read_prob_tile_reads())


def ragged_tail_batches(tile: int, seed: int = 1):
    """``pack_sites`` batches whose read counts end phase A's tile of
    ``tile`` reads raggedly: 1, 2, 3, 255, 257, tile - 1, tile + 1 and 4097
    reads.  Each is sites of 1 to 8 reads, then n // 8 padding reads and two
    padding sites, as numpy ``(features, kmer_ids, offsets, counts)`` drawn
    from ``seed``: the cases on which the card tests and ``chip_smoke.py``
    hold the kernel against its plain version."""
    rng = np.random.default_rng(seed)
    batches = []
    for n in sorted({1, 2, 3, 255, 257, tile - 1, tile + 1, 4097}):
        counts, left = [], n - n // 8
        while left > 0:
            counts.append(min(left, int(rng.integers(1, 9))))
            left -= counts[-1]
        counts = np.array(counts + [0, 0], np.int32)
        offsets = np.where(counts > 0, np.cumsum(counts) - counts, 0).astype(np.int32)
        features = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
        kmer_ids = rng.integers(0, VOCAB, size=(n, N_POSITIONS)).astype(np.int8)
        batches.append((features, kmer_ids, offsets, counts))
    return batches


def check_tensor(name: str, t: torch.Tensor, dtypes, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


SITE_IDS_ERROR = (
    "site_ids must follow pack_sites' dense layout: site s owns the reads "
    "from sum(counts[:s]) on, and padding reads carry site_ids == S"
)


def _check_kmer_range(kmer_ids: torch.Tensor, bad_site_ids: Optional[torch.Tensor] = None) -> None:
    """Raise on a k-mer id outside [0, 66) (pack_sites never makes one) and,
    given ``bad_site_ids`` (a 0-d bool tensor), on site ids off the dense
    layout, on either device; on the card this waits for the checks'
    results, in one host sync."""
    flags = [((kmer_ids < 0) | (kmer_ids >= VOCAB)).any()]
    if bad_site_ids is not None:
        flags.append(bad_site_ids)
    bad_kmer, *bad_ids = torch.stack(flags).tolist()
    if bad_kmer:
        raise ValueError(f"kmer_ids must lie in [0, {VOCAB})")
    if any(bad_ids):
        raise ValueError(SITE_IDS_ERROR)


def fused_inference_t(
    fp: FusedParamsT,
    features: torch.Tensor,  # (N, 9) f32
    kmer_ids: torch.Tensor,  # (N, 3) int8 or int32
    site_ids: Optional[torch.Tensor],  # (N,) i32, or None (derived from offsets/counts)
    offsets: torch.Tensor,  # (S,) i32 first read of each site
    counts: torch.Tensor,  # (S,) i32 reads per site, 0 = padding site
    threshold: float,
    n_samples: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (p (N,), site_p (S,), mod_ratio (S,)) for a ``pack_sites``
    batch.  CPU tensors run the plain version; CUDA tensors launch the
    kernel, which reads the site spans from (offsets, counts) and ignores
    ``site_ids``.  The kernel reads int8 k-mer ids: int32 ids are checked
    and narrowed first."""
    global launch_count
    if features.device.type == "cpu":
        return fused_inference_t_plain(
            fp, features, kmer_ids, site_ids, offsets, counts, threshold, n_samples
        )
    out = _launch_fused(fp, features, kmer_ids, offsets, counts, threshold, n_samples, "fused_inference_t")
    launch_count += 1
    return out


def check_read_inputs(
    fp: FusedParamsT,
    features: torch.Tensor,
    kmer_ids: torch.Tensor,
    name: str,
    bad_site_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Check the per-read inputs of a kernel launch (and ``bad_site_ids``,
    in the same host sync); return the k-mer ids as the int8 the kernel
    reads."""
    if features.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {features.device}")
    device, n = features.device, features.shape[0]
    check_tensor("features", features, (torch.float32,), (n, N_FEATURES), device)
    check_tensor("kmer_ids", kmer_ids, (torch.int8, torch.int32), (n, N_POSITIONS), device)
    check_tensor("fp.packed", fp.packed, (torch.float32,), (PACKED_WEIGHTS,), device)
    _check_kmer_range(kmer_ids, bad_site_ids)
    return kmer_ids.to(torch.int8)


def launch_error(lib: ctypes.CDLL, err: int) -> RuntimeError:
    return RuntimeError(f"fused_infer kernel launch failed: {lib.fused_infer_error_string(err).decode()}")


def _launch_fused(fp, features, kmer_ids, offsets, counts, threshold, n_samples, name, bad_site_ids=None):
    """Check the inputs and launch both phases of the kernel."""
    device = features.device
    n, n_sites = features.shape[0], counts.shape[0]
    if device.type == "cuda":
        check_tensor("offsets", offsets, (torch.int32,), (n_sites,), device)
        check_tensor("counts", counts, (torch.int32,), (n_sites,), device)
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0, got {n_samples}")
    kmer_ids = check_read_inputs(fp, features, kmer_ids, name, bad_site_ids)

    lib = kernel_lib()
    p = torch.empty(n, dtype=torch.float32, device=device)
    site_p = torch.empty(n_sites, dtype=torch.float32, device=device)
    mod_ratio = torch.empty(n_sites, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_infer_launch(
            features.data_ptr(), kmer_ids.data_ptr(),
            offsets.data_ptr(), counts.data_ptr(), fp.packed.data_ptr(),
            p.data_ptr(), site_p.data_ptr(), mod_ratio.data_ptr(),
            n, n_sites, float(threshold), int(n_samples), stream,
        )
    if err != 0:
        raise launch_error(lib, err)
    return p, site_p, mod_ratio


def fused_inference_plain(
    fp: FusedParamsT,
    features: torch.Tensor,
    kmer_ids: torch.Tensor,
    site_ids: torch.Tensor,
    counts: torch.Tensor,
    threshold: float,
    n_samples: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fused_inference`'s function in plain PyTorch: site sums over
    the given site ids (padding reads carry ``site_ids == S``)."""
    n_sites = counts.shape[0]
    p = read_probability_plain(fp, features, kmer_ids)
    site_p = site_ops.site_probability_exact(p, site_ids, counts, n_sites, n_samples)
    mod_ratio = site_ops.mod_ratio_exact(p, site_ids, counts, n_sites, threshold)
    return p, site_p, mod_ratio


def fused_inference(
    fp: FusedParamsT,
    features: torch.Tensor,  # (N, 9) f32
    kmer_ids: torch.Tensor,  # (N, 3) int8 or int32
    site_ids: torch.Tensor,  # (N,) i32, consecutive per pack_sites; padding == S
    counts: torch.Tensor,  # (S,) i32 reads per site, 0 = padding site
    threshold: float,
    n_samples: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (p (N,), site_p (S,), mod_ratio (S,)), as
    :func:`fused_inference_t`, for a batch given by per-read site ids.
    ``site_ids`` must follow ``pack_sites``' dense layout (site s owns the
    reads from the exclusive cumsum of the counts on), as the JAX function
    requires: both devices raise on ids that do not.  CPU tensors then run
    the plain version; on CUDA tensors the kernel reads the spans from the
    counts."""
    global fused_inference_launch_count
    n = features.shape[0]
    if features.device.type == "cuda":
        check_tensor("site_ids", site_ids, (torch.int32,), (n,), features.device)
        check_tensor("counts", counts, (torch.int32,), (counts.shape[0],), features.device)
    ends = torch.cumsum(counts.long(), 0)
    dense = torch.searchsorted(ends, torch.arange(n, device=ends.device), right=True)
    bad_site_ids = (site_ids.long() != dense).any()
    if features.device.type == "cpu":
        if bool(bad_site_ids):
            raise ValueError(SITE_IDS_ERROR)
        return fused_inference_plain(fp, features, kmer_ids, site_ids, counts, threshold, n_samples)
    offsets = (ends - counts).to(torch.int32).contiguous()
    out = _launch_fused(
        fp, features, kmer_ids, offsets, counts, threshold, n_samples, "fused_inference", bad_site_ids
    )
    fused_inference_launch_count += 1
    return out
