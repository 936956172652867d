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

The site phase (phase B, ``site_reduce_kernel`` of ``csrc/fused_infer.cu``)
runs after every phase A of the fused entry points; its launches are
counted in ``site_reduce_launch_count``.

The k-mer ids must lie in [0, 66) (the kernels read the embedding table
with them unchecked).  By default the wrappers check the tensor on its
device, which on the card costs one host sync a call.  Given
``host_kmer_ids``, the host array the tensor was copied from as
:func:`checked_kmer_ids` returns it (checked on the host, for example on
the engine's pack thread), the wrapper touches no device data and makes no
sync.

Every entry point takes ``precision``, the JAX kernels' ``compute_dtype``:
``"f32"`` (the kernel above), or the reduced modes ``"f32x3"`` and
``"bf16"``, whose phase A is the tensor-core kernel of
``csrc/read_prob_tc.cu`` (its launches counted per mode in
``tc_launch_counts``), followed on the fused entry points by the f32
kernel's own site phase.  The modes follow the JAX ``fused_inference_t``'s
arithmetic (``_fused_infer_kernel_t``), per read:

* f32x3: the embedding value is ``hi + lo`` (``hi = bf16(e)``, ``lo =
  bf16(e - hi)``); layer 1 in full f32; layer 2 and the head take
  ``(a_lo b_hi + a_hi b_lo) + a_hi b_hi`` over bf16 splits of both operands
  with f32 sums;
* bf16: every product is ``bf16(W) @ bf16(input)`` with f32 sums, the
  embedding value ``bf16(e)``;

and both add the f32 biases after each product.  The plain versions of the
reduced modes take every sum in the kernel's order (``read_probability_plain``)
and sum the tensor-core products as the kernel does (in k16 chunks, each
truncated toward zero), so the two differ by the tensor cores' rounding
inside a chunk alone.  The order matters beyond an ulp: f32x3 rounds the
low half of each split to bf16, so one ulp of h1 or h2 can move a low half
by a bf16 step of its own, which a model that amplifies its inputs (such as
HEK293T_RNA004) turns into ~7e-6 of p (PERF.md section 6, PR 9).
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

# launches of the CUDA kernels in this process, by wrapper: one per
# fused_inference_t / fused_inference call on CUDA tensors (any precision),
# one per launch of phase B (site_reduce_kernel), and one per launch of
# read_prob_tc.cu, by precision
launch_count = 0
fused_inference_launch_count = 0
site_reduce_launch_count = 0
tc_launch_counts = {"f32x3": 0, "bf16": 0}

N_FEATURES, N_POSITIONS, VOCAB, EMB_DIM, HIDDEN1, HIDDEN2 = 9, 3, 66, 2, 150, 32
PACKED_WEIGHTS = 7400  # float count of the kernel's weight image (see the .cu)
PRECISIONS = ("f32", "f32x3", "bf16")
# the tensor-core kernel's mode argument (kModeF32x3, kModeBf16 in the .cu)
TC_MODES = {"f32x3": 1, "bf16": 2}
# what read_prob_tc_config reports of the tensor-core kernel's launch
TC_CONFIG_KEYS = ("threads", "consumer_warpgroups", "stages", "tile_reads", "dynamic_smem_bytes")

# The tensor-core image (32-bit words; csrc/read_prob_tc.cu documents it).
# Hidden units are padded to 160 with zero weights and zero bias: layer 1's
# N is 20 n8 tiles, layer 2's K is 10 k16 steps.
HIDDEN1_PAD = 160
TC_K_STEPS, TC_TILES1, TC_TILES2 = HIDDEN1_PAD // 16, HIDDEN1_PAD // 8, HIDDEN2 // 8
TC_OFF_W1F = 0
TC_OFF_EMBX = TC_OFF_W1F + HIDDEN1_PAD * 16
TC_OFF_W3L = TC_OFF_EMBX + VOCAB * EMB_DIM
TC_OFF_W2L = TC_OFF_W3L + HIDDEN2
TC_OFF_W2H = TC_OFF_W2L + TC_K_STEPS * TC_TILES2 * 64
TC_OFF_B2 = TC_OFF_W2H + TC_K_STEPS * TC_TILES2 * 64
TC_OFF_W3H = TC_OFF_B2 + HIDDEN2
TC_OFF_B3 = TC_OFF_W3H + HIDDEN2
TC_OFF_W1H = TC_OFF_B3 + 4
TC_OFF_B1 = TC_OFF_W1H + TC_TILES1 * 64
TC_OFF_EMBH = TC_OFF_B1 + HIDDEN1_PAD
TC_WORDS = TC_OFF_EMBH + VOCAB * EMB_DIM  # 9484


class FusedParamsT(NamedTuple):
    """Transposed parameter set (the JAX package's ``FusedEncoderParamsT``)
    plus the packed weight images the CUDA kernels stage in shared memory."""

    w1t: torch.Tensor  # (150, 15) BN-folded first linear
    embt: torch.Tensor  # (2, 66) embedding, transposed
    b1t: torch.Tensor  # (150, 1)
    w2t: torch.Tensor  # (32, 150)
    b2t: torch.Tensor  # (32, 1)
    w3t: torch.Tensor  # (1, 32)
    b3t: torch.Tensor  # (1, 1)
    packed: torch.Tensor  # (7400,) f32, layout documented in csrc/fused_infer.cu
    tc: torch.Tensor  # (9484,) int32 words, layout documented in csrc/read_prob_tc.cu


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


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even), back in f32."""
    return t.to(torch.bfloat16).float()


def bf16_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with ``hi = bf16(t)`` and ``lo = bf16(t - hi)``, in f32."""
    hi = bf16_round(t)
    return hi, bf16_round(t - hi)


def _bf16x2_words(pairs: torch.Tensor) -> torch.Tensor:
    """int32 words of bf16 pairs (last dim 2): element 0 in the low half,
    as an ``mma`` operand register holds the smaller k index."""
    bits = pairs.contiguous().to(torch.bfloat16).view(torch.int16).to(torch.int32)
    return (bits[..., 0] & 0xFFFF) | (bits[..., 1] << 16)


def _pack_tc(w1t, embt, b1t, w2t, b2t, w3t, b3t) -> torch.Tensor:
    """The tensor-core kernel's image: layer 1 of f32x3 in the order its
    lanes read it (lane t of a quad computes 4 units a k step), and each
    ``wgmma`` B operand in the canonical K-major layout without swizzle."""
    pad = HIDDEN1_PAD - HIDDEN1
    w1b = torch.cat([w1t, b1t], dim=1)  # (150, 16): W1'[n, 0:15], b1'[n]
    w1b = torch.cat([w1b, w1b.new_zeros(pad, 16)])  # (160, 16)
    j, c, t = torch.meshgrid(torch.arange(TC_K_STEPS), torch.arange(4), torch.arange(4), indexing="ij")
    unit = 16 * j + 2 * t + (c & 1) + 8 * (c >> 1)  # the 4 units lane t computes in k step j
    w1f = w1b.view(HIDDEN1_PAD, 4, 4)[unit].permute(0, 1, 3, 2, 4)  # [j][c][q][t][4]

    # B (n x k16): core matrices of 8 n x 8 k, the two k halves of a k16
    # step side by side, then the groups of 8 n
    w1k = torch.cat([w1t, w1t.new_zeros(HIDDEN1, 1)], dim=1)  # k = 15 is zero, never the bias
    w1k = torch.cat([w1k, w1k.new_zeros(pad, 16)])  # (160, 16)
    w1h = w1k.reshape(TC_TILES1, 8, 2, 8).permute(0, 2, 1, 3)  # [n group][k half][n][k]
    w2k = torch.cat([w2t, w2t.new_zeros(HIDDEN2, pad)], dim=1)  # (32, 160)
    w2 = w2k.reshape(TC_TILES2, 8, TC_K_STEPS, 2, 8).permute(2, 0, 3, 1, 4)  # [step][n group][k half][n][k]
    w2_hi, w2_lo = bf16_split(w2)
    emb = embt.t()
    emb_hi, emb_lo = bf16_split(emb)
    w3_hi, w3_lo = bf16_split(w3t.reshape(-1))

    def words(f32: torch.Tensor) -> torch.Tensor:
        return f32.contiguous().view(torch.int32).reshape(-1)

    parts = [
        words(w1f),  # W1F
        words(emb_hi + emb_lo),  # EMBX
        words(w3_lo),  # W3L
        _bf16x2_words(w2_lo.reshape(-1, 2)),  # W2L
        _bf16x2_words(w2_hi.reshape(-1, 2)),  # W2H
        words(b2t.reshape(-1)),  # B2
        words(w3_hi),  # W3H
        words(torch.cat([b3t.reshape(-1), b3t.new_zeros(3)])),  # B3, zero padding
        _bf16x2_words(w1h.reshape(-1, 2)),  # W1H
        words(torch.cat([b1t.reshape(-1), b1t.new_zeros(pad)])),  # B1
        words(bf16_round(emb)),  # EMBH
    ]
    image = torch.cat(parts).contiguous()
    assert image.numel() == TC_WORDS
    return image


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
    tc = _pack_tc(**{name: t.cpu() for name, t in tensors.items()}).to(tensors["w1t"].device)
    return FusedParamsT(**tensors, packed=_pack(**tensors), tc=tc)


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _round_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """f64 ``v`` rounded toward zero to f32."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of bf16-valued operands as the tensor-core kernel sums
    it: over k in chunks of 16 (one ``mma`` k step each, into a zero
    accumulator), each chunk's products summed exactly (f64) and truncated
    toward zero to f32, the chunks added in f32 in order.  The truncation
    is the tensor cores' own: on an H100, f32 sums of the chunks rounded to
    nearest left 18 of 1,048,576 f32x3 reads more than 1e-6 from the
    kernel, truncated sums one (scripts/sweep_read_prob_tc.py)."""
    out = None
    for k in range(0, a.shape[1], 16):
        part = _round_toward_zero(torch.matmul(a[:, k : k + 16].double(), b[:, k : k + 16].double().t()))
        out = part if out is None else out + part
    return out


def _tensor_core_accumulate(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``acc + a @ b.T`` as one tensor-core accumulator takes it (``wgmma``
    with scale-d 1): each k16 chunk's products summed exactly with the
    accumulator and truncated toward zero to f32, chunk after chunk."""
    for k in range(0, a.shape[1], 16):
        acc = _round_toward_zero(acc.double() + torch.matmul(a[:, k : k + 16].double(), b[:, k : k + 16].double().t()))
    return acc


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf(a, b, c)``: the product is exact in f64; the f64 sum
    rounds once more before f32, which differs from one rounding only where
    it lands on an f32 tie."""
    return (a.double() * b.double() + c.double()).float()


def _fma_chain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (x (N, K), w (M, K)) in the kernels' layer-1 order:
    ``x[0] w[0]`` rounded, then one ``fmaf`` per k in order."""
    u = x[:, :1] * w[:, 0]
    for k in range(1, x.shape[1]):
        u = _fma(w[:, k], x[:, k : k + 1], u)
    return u


def _lane_dot(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``v @ w`` (v (N, 32), w (32,)) in the order of read_prob_tc.cu's
    head: lane t of a quad takes units 8 nt + 2t + e (nt, then e, in order)
    with ``fmaf`` from 0, and the quad adds its four sums as
    (t0 + t1) + (t2 + t3) (two xor shuffles)."""
    lanes = []
    for t in range(4):
        acc = v.new_zeros(v.shape[0])
        for nt in range(HIDDEN2 // 8):
            for e in range(2):
                n = 8 * nt + 2 * t + e
                acc = _fma(w[n], v[:, n], acc)
        lanes.append(acc)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def read_probability_plain(
    fp: FusedParamsT, features: torch.Tensor, kmer_ids: torch.Tensor, precision: str = "f32"
) -> torch.Tensor:
    """Phase A's function in plain PyTorch: per-read p (N,).  f32 takes f32
    matmuls.  The reduced modes round their operands as the module's
    docstring sets out and follow ``read_prob_tc.cu``'s arithmetic step by
    step: every f32 sum in the kernel's order (layer 1's FMA chain in f32x3,
    the head's per-lane FMAs and quad sum, the biases where the kernel adds
    them), and every product the kernel takes on the tensor cores summed as
    they do, in k16 chunks truncated toward zero (``_tensor_core_matmul``;
    f32x3's cross products in one accumulator, ``_tensor_core_accumulate``)."""
    check_precision(precision)
    _check_kmer_range(kmer_ids)
    n = features.shape[0]
    table = fp.embt.t()
    if precision == "f32x3":
        hi, lo = bf16_split(table)
        table = hi + lo
    elif precision == "bf16":
        table = bf16_round(table)
    x = torch.cat([features, table[kmer_ids.long()].reshape(n, -1)], dim=1)
    b1, b2, b3 = fp.b1t.reshape(-1), fp.b2t.reshape(-1), fp.b3t.reshape(-1)
    if precision == "f32":
        h = torch.relu(torch.matmul(x, fp.w1t.t()) + b1)
        h = torch.relu(torch.matmul(h, fp.w2t.t()) + b2)
        return torch.sigmoid(torch.matmul(h, fp.w3t.t()) + b3).reshape(-1)
    if precision == "f32x3":
        h = torch.relu(_fma_chain(x, fp.w1t) + b1)  # layer 1 stays f32 (the JAX kernel's dot1)
        h_hi, h_lo = bf16_split(h)
        w2_hi, w2_lo = bf16_split(fp.w2t)
        cross = h.new_zeros(n, HIDDEN2)
        for k in range(0, HIDDEN1, 16):  # W2lo.h1hi, then W2hi.h1lo, a k16 step at a time
            ks = slice(k, k + 16)
            cross = _tensor_core_accumulate(cross, h_hi[:, ks], w2_lo[:, ks])
            cross = _tensor_core_accumulate(cross, h_lo[:, ks], w2_hi[:, ks])
        h = torch.relu((cross + _tensor_core_matmul(h_hi, w2_hi)) + b2)
        v_hi, v_lo = bf16_split(h)
        w3_hi, w3_lo = bf16_split(fp.w3t.reshape(-1))
        z = ((_lane_dot(v_hi, w3_lo) + _lane_dot(v_lo, w3_hi)) + _lane_dot(v_hi, w3_hi)) + b3
    else:
        h = torch.relu(_tensor_core_matmul(bf16_round(x), bf16_round(fp.w1t)) + b1)
        h = torch.relu(_tensor_core_matmul(bf16_round(h), bf16_round(fp.w2t)) + b2)
        z = _lane_dot(bf16_round(h), bf16_round(fp.w3t.reshape(-1))) + b3
    return 1.0 / (1.0 + torch.exp(-z))


def fused_inference_t_plain(
    fp: FusedParamsT,
    features: torch.Tensor,
    kmer_ids: torch.Tensor,
    site_ids: Optional[torch.Tensor],
    offsets: torch.Tensor,
    counts: torch.Tensor,
    threshold: float,
    n_samples: int = 20,
    precision: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (f32 matmuls, f64 site sums),
    in ``precision``."""
    n, n_sites = features.shape[0], counts.shape[0]
    if site_ids is None:
        site_ids = site_ops.derive_site_ids(offsets, counts, n, n_sites)
    p = read_probability_plain(fp, features, kmer_ids, precision)
    site_p = site_ops.site_probability_exact(p, site_ids, counts, n_sites, n_samples)
    mod_ratio = site_ops.mod_ratio_exact(p, site_ids, counts, n_sites, threshold)
    return p, site_p, mod_ratio


# the C interfaces of csrc/fused_infer.cu's launches (fused_infer_launch:
# features, kmer_ids, offsets, counts, weights, p, site_p, mod_ratio,
# n_reads, n_sites, threshold, n_samples, stream; site_reduce_launch: p,
# offsets, counts, site_p, mod_ratio, n_reads, n_sites, threshold,
# n_samples, stream) and of read_prob_tc.cu's (features, kmer_ids, image,
# p, n_reads, mode, stream)
FUSED_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                                          ctypes.c_void_p]
SITE_REDUCE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p]
TC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ._build import cuda_library

            lib = ctypes.CDLL(cuda_library("fused_infer"))
            lib.fused_infer_launch.restype = ctypes.c_int
            lib.fused_infer_launch.argtypes = FUSED_ARGTYPES
            lib.read_prob_launch.restype = ctypes.c_int
            lib.read_prob_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
            lib.read_prob_tile_reads.restype = ctypes.c_int
            lib.read_prob_tile_reads.argtypes = []
            lib.site_reduce_launch.restype = ctypes.c_int
            lib.site_reduce_launch.argtypes = SITE_REDUCE_ARGTYPES
            lib.fused_infer_error_string.restype = ctypes.c_char_p
            lib.fused_infer_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


_tc_lib: Optional[ctypes.CDLL] = None


def tc_kernel_lib() -> ctypes.CDLL:
    """The tensor-core phase A of csrc/read_prob_tc.cu, built if needed."""
    global _tc_lib
    with _lib_lock:
        if _tc_lib is None:
            from ._build import cuda_library

            lib = ctypes.CDLL(cuda_library("read_prob_tc"))
            lib.read_prob_tc_launch.restype = ctypes.c_int
            lib.read_prob_tc_launch.argtypes = TC_ARGTYPES
            lib.read_prob_tc_config.restype = ctypes.c_int
            lib.read_prob_tc_config.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.read_prob_tc_error_string.restype = ctypes.c_char_p
            lib.read_prob_tc_error_string.argtypes = [ctypes.c_int]
            _tc_lib = lib
    return _tc_lib


def read_tile_reads(precision: str = "f32") -> int:
    """Reads phase A takes per tile (f32: threads per block x reads per
    thread; the reduced modes: the 64-read tiles of one consumer
    warpgroup's item, which differ by mode); builds the kernel if needed."""
    check_precision(precision)
    if precision == "f32":
        return int(kernel_lib().read_prob_tile_reads())
    return tc_kernel_config(precision)["tile_reads"]


def tc_kernel_config(precision: str) -> dict:
    """The tensor-core kernel's launch in ``precision`` ("f32x3" or "bf16"),
    by ``TC_CONFIG_KEYS``; builds the kernel if needed."""
    out = (ctypes.c_int32 * len(TC_CONFIG_KEYS))()
    if tc_kernel_lib().read_prob_tc_config(TC_MODES[precision], out) != 0:
        raise RuntimeError(f"read_prob_tc has no launch for precision {precision!r}")
    return dict(zip(TC_CONFIG_KEYS, out))


def launch_read_prob_tc(fp: FusedParamsT, features: torch.Tensor, kmer_ids: torch.Tensor,
                        p: torch.Tensor, precision: str) -> None:
    """Launch the tensor-core phase A of ``precision`` ("f32x3" or "bf16")
    into ``p`` on the current stream, on inputs that check_read_inputs has
    checked, and count the launch."""
    check_tensor("fp.tc", fp.tc, (torch.int32,), (TC_WORDS,), features.device)
    lib = tc_kernel_lib()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = lib.read_prob_tc_launch(
            features.data_ptr(), kmer_ids.data_ptr(), fp.tc.data_ptr(), p.data_ptr(),
            features.shape[0], TC_MODES[precision], stream,
        )
    if err != 0:
        raise RuntimeError(f"read_prob_tc kernel launch failed: {lib.read_prob_tc_error_string(err).decode()}")
    tc_launch_counts[precision] += 1


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


class CheckedKmerIds(NamedTuple):
    """Host k-mer ids (N, 3) int8 whose range :func:`checked_kmer_ids` has
    checked: what a wrapper's ``host_kmer_ids`` takes."""

    ids: np.ndarray


def checked_kmer_ids(kmer_ids: np.ndarray) -> CheckedKmerIds:
    """Check host k-mer ids for the range [0, 66) on the host and return
    them as int8, marked as checked; raise ValueError on any other id.  An
    int8 array takes one pass as uint8, where negative ids read as >= 128;
    wider ids are checked before they are narrowed."""
    ids = np.asarray(kmer_ids)
    if not np.issubdtype(ids.dtype, np.integer):
        raise ValueError(f"kmer_ids must be integers, got {ids.dtype}")
    if ids.dtype == np.int8:
        bad = ids.size > 0 and int(ids.view(np.uint8).max()) >= VOCAB
    else:
        bad = ids.size > 0 and (int(ids.min()) < 0 or int(ids.max()) >= VOCAB)
    if bad:
        raise ValueError(f"kmer_ids must lie in [0, {VOCAB})")
    return CheckedKmerIds(ids.astype(np.int8, copy=False))


def check_host_kmer_ids(host_kmer_ids: CheckedKmerIds, kmer_ids: torch.Tensor) -> None:
    """Raise unless ``host_kmer_ids`` is checked_kmer_ids' result for an
    array of ``kmer_ids``' shape."""
    if not isinstance(host_kmer_ids, CheckedKmerIds):
        raise TypeError("host_kmer_ids must be what checked_kmer_ids returns")
    if host_kmer_ids.ids.shape != tuple(kmer_ids.shape):
        raise ValueError(
            f"host_kmer_ids have shape {host_kmer_ids.ids.shape}, expected {tuple(kmer_ids.shape)} like kmer_ids"
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
    precision: str = "f32",
    host_kmer_ids: Optional[CheckedKmerIds] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (p (N,), site_p (S,), mod_ratio (S,)) for a ``pack_sites``
    batch, in ``precision``.  CPU tensors run the plain version; CUDA
    tensors launch the kernels, which read the site spans from (offsets,
    counts) and ignore ``site_ids``.  The kernels read int8 k-mer ids:
    int32 ids are checked and narrowed first.  ``host_kmer_ids``
    (:func:`checked_kmer_ids` of the array ``kmer_ids`` was copied from)
    replaces the check on the device, and its host sync."""
    global launch_count
    check_precision(precision)
    if host_kmer_ids is not None:
        check_host_kmer_ids(host_kmer_ids, kmer_ids)
    if features.device.type == "cpu":
        return fused_inference_t_plain(
            fp, features, kmer_ids, site_ids, offsets, counts, threshold, n_samples, precision
        )
    out = _launch_fused(
        fp, features, kmer_ids, offsets, counts, threshold, n_samples, "fused_inference_t", precision,
        host_checked=host_kmer_ids is not None,
    )
    launch_count += 1
    return out


def check_read_inputs(
    fp: FusedParamsT,
    features: torch.Tensor,
    kmer_ids: torch.Tensor,
    name: str,
    bad_site_ids: Optional[torch.Tensor] = None,
    host_checked: bool = False,
) -> torch.Tensor:
    """Check the per-read inputs of a kernel launch (and ``bad_site_ids``,
    in the same host sync); return the k-mer ids as the int8 the kernel
    reads.  ``host_checked``: the caller checked the ids' range on the host
    (``host_kmer_ids``), so only their type and shape are checked here, and
    nothing waits for the device."""
    if features.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {features.device}")
    device, n = features.device, features.shape[0]
    check_tensor("features", features, (torch.float32,), (n, N_FEATURES), device)
    check_tensor("kmer_ids", kmer_ids, (torch.int8, torch.int32), (n, N_POSITIONS), device)
    check_tensor("fp.packed", fp.packed, (torch.float32,), (PACKED_WEIGHTS,), device)
    if not host_checked:
        _check_kmer_range(kmer_ids, bad_site_ids)
    return kmer_ids.to(torch.int8)


def launch_error(lib: ctypes.CDLL, err: int) -> RuntimeError:
    return RuntimeError(f"fused_infer kernel launch failed: {lib.fused_infer_error_string(err).decode()}")


def _launch_fused(fp, features, kmer_ids, offsets, counts, threshold, n_samples, name, precision,
                  bad_site_ids=None, host_checked=False):
    """Check the inputs and launch both phases: fused_infer.cu's in f32; in
    a reduced mode read_prob_tc.cu's phase A, then fused_infer.cu's phase
    B."""
    global site_reduce_launch_count
    device = features.device
    n, n_sites = features.shape[0], counts.shape[0]
    if device.type == "cuda":
        check_tensor("offsets", offsets, (torch.int32,), (n_sites,), device)
        check_tensor("counts", counts, (torch.int32,), (n_sites,), device)
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0, got {n_samples}")
    kmer_ids = check_read_inputs(fp, features, kmer_ids, name, bad_site_ids, host_checked)

    lib = kernel_lib()
    p = torch.empty(n, dtype=torch.float32, device=device)
    site_p = torch.empty(n_sites, dtype=torch.float32, device=device)
    mod_ratio = torch.empty(n_sites, dtype=torch.float32, device=device)
    if precision != "f32":
        launch_read_prob_tc(fp, features, kmer_ids, p, precision)
        launch_site_reduce(p, offsets, counts, threshold, n_samples, site_p, mod_ratio)
        return p, site_p, mod_ratio
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
    if n_sites > 0:
        site_reduce_launch_count += 1
    return p, site_p, mod_ratio


def site_reduce_plain(
    p: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor, threshold: float, n_samples: int = 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase B's function in plain PyTorch: (site_p, mod_ratio) of the spans
    [offsets[s], offsets[s] + counts[s]) of ``p``, with the site ops' exact
    sums; NaN for both at a site whose span leaves ``p``."""
    n, n_sites = p.shape[0], counts.shape[0]
    off, cnt = offsets.long(), counts.long()
    bad = (cnt < 0) | (off < 0) | (off + cnt > n)
    take = torch.where(bad, torch.zeros_like(cnt), cnt)
    seg = torch.repeat_interleave(torch.arange(n_sites, device=p.device), take)
    first = torch.repeat_interleave(off - (torch.cumsum(take, 0) - take), take)
    values = p[torch.arange(seg.numel(), device=p.device) + first]
    site_p = site_ops.site_probability_exact(values, seg, take, n_sites, n_samples)
    mod_ratio = site_ops.mod_ratio_exact(values, seg, take, n_sites, threshold)
    nan = torch.full_like(site_p, float("nan"))
    return torch.where(bad, nan, site_p), torch.where(bad, nan, mod_ratio)


def site_reduce(
    p: torch.Tensor,  # (N,) f32 per-read probabilities
    offsets: torch.Tensor,  # (S,) i32 first read of each site
    counts: torch.Tensor,  # (S,) i32 reads per site, 0 = padding site
    threshold: float,
    n_samples: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase B alone: (site_p (S,), mod_ratio (S,)) of the spans of ``p``,
    as the fused entry points compute them after their phase A.  CPU
    tensors run :func:`site_reduce_plain`; CUDA tensors launch
    ``site_reduce_kernel``, which gives the same bits for p in [0, 1] or
    NaN and NaN site_p at a site holding a read outside [0, 1]."""
    if p.device.type == "cpu":
        return site_reduce_plain(p, offsets, counts, threshold, n_samples)
    if p.device.type != "cuda":
        raise ValueError(f"site_reduce runs on cpu or cuda, got {p.device}")
    n_sites = counts.shape[0]
    check_tensor("p", p, (torch.float32,), (p.shape[0],), p.device)
    check_tensor("offsets", offsets, (torch.int32,), (n_sites,), p.device)
    check_tensor("counts", counts, (torch.int32,), (n_sites,), p.device)
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0, got {n_samples}")
    site_p = torch.empty(n_sites, dtype=torch.float32, device=p.device)
    mod_ratio = torch.empty(n_sites, dtype=torch.float32, device=p.device)
    launch_site_reduce(p, offsets, counts, threshold, n_samples, site_p, mod_ratio)
    return site_p, mod_ratio


def launch_site_reduce(p, offsets, counts, threshold, n_samples, site_p, mod_ratio) -> None:
    """Launch phase B on the current stream, on checked inputs, and count
    the launch."""
    global site_reduce_launch_count
    n_sites = counts.shape[0]
    if n_sites == 0:
        return
    lib = kernel_lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.site_reduce_launch(
            p.data_ptr(), offsets.data_ptr(), counts.data_ptr(), site_p.data_ptr(), mod_ratio.data_ptr(),
            p.shape[0], n_sites, float(threshold), int(n_samples), stream,
        )
    if err != 0:
        raise launch_error(lib, err)
    site_reduce_launch_count += 1


# p values at the edges of phase B's exact sums: 1 - p is a whole number of
# 2^-24 units for each, from 2^24 (p = 0) down to 0 (p = 1)
PHASE_B_EDGES = np.array([0.0, 2.0**-149, 2.0**-25, 0.5 - 2.0**-25, 0.5, 1 - 2.0**-24, 1.0], np.float32)


def site_reduce_batch(seed: int = 3, nan_reads: bool = True):
    """``(p, offsets, counts)`` (numpy) on which the card tests and
    ``chip_smoke.py`` hold phase B alone against its plain version: sites of
    1, 20-1,000 and 57,344 reads (``mc_kernel.MAX_SITE_READS``), count-0
    sites between real ones and at the end, a 1,000-read site of p = 0
    (every step's warp sum at its 2^31 ceiling) and one of p = 1,
    ``PHASE_B_EDGES`` at every seventh read, with ``nan_reads`` a NaN read
    in three sites, and NaN padding reads past the last site (never read).
    Offsets fall on every 16-byte phase."""
    rng = np.random.default_rng(seed)
    body = rng.integers(20, 1001, size=400)
    body[::9], body[4::31] = 1, 0
    counts = np.array([1, 0, 57344, 1000, 1000, 3, 1] + list(body) + [0] * 16, np.int32)
    offsets = np.zeros_like(counts)
    offsets[1:] = np.cumsum(counts)[:-1]
    total = int(counts.sum())
    p = rng.uniform(0.0, 1.0, size=total + 77).astype(np.float32)
    p[::7] = np.resize(PHASE_B_EDGES, p[::7].shape)
    p[offsets[3] : offsets[3] + 1000] = 0.0
    p[offsets[4] : offsets[4] + 1000] = 1.0
    if nan_reads:
        for site in (2, 5, 20):
            p[offsets[site] + counts[site] // 2] = np.nan
    p[total:] = np.nan
    return p, offsets, counts


def fused_inference_plain(
    fp: FusedParamsT,
    features: torch.Tensor,
    kmer_ids: torch.Tensor,
    site_ids: torch.Tensor,
    counts: torch.Tensor,
    threshold: float,
    n_samples: int = 20,
    precision: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fused_inference`'s function in plain PyTorch: site sums over
    the given site ids (padding reads carry ``site_ids == S``)."""
    n_sites = counts.shape[0]
    p = read_probability_plain(fp, features, kmer_ids, precision)
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
    precision: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (p (N,), site_p (S,), mod_ratio (S,)), as
    :func:`fused_inference_t`, for a batch given by per-read site ids.
    ``site_ids`` must follow ``pack_sites``' dense layout (site s owns the
    reads from the exclusive cumsum of the counts on), as the JAX function
    requires: both devices raise on ids that do not.  CPU tensors then run
    the plain version; on CUDA tensors the kernel reads the spans from the
    counts."""
    global fused_inference_launch_count
    check_precision(precision)
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
        return fused_inference_plain(fp, features, kmer_ids, site_ids, counts, threshold, n_samples, precision)
    offsets = (ends - counts).to(torch.int32).contiguous()
    out = _launch_fused(
        fp, features, kmer_ids, offsets, counts, threshold, n_samples, "fused_inference", precision,
        bad_site_ids,
    )
    fused_inference_launch_count += 1
    return out
