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

The kernels take the production architecture at any widths
(``kernel_limit`` names the one limit left, a vocabulary past the int16
ids): P k-mer positions (3 P signal features), an embedding of E
dimensions over a vocabulary of V k-mers, hidden widths H1 and H2.  The
widths are compile-time constants of each kernel: a model of other widths
than the released ones (``PRODUCTION``) builds its own libraries at first
use, from the same sources with ``-D`` defines (``kernel_defines``), and
packs its weights by the layouts of those widths (``f32_layout``,
``tc_layout``).  The sources derive their plan from the widths: within
the widths of their fast plans the kernels stage the weights in shared
memory; past them (a thread's registers or a block's shared memory) each
phase A takes its wide plan, whose kernel stages the weights a step of
hidden units at a time for a block's tile of reads (``phase_a_wide``; its
launches counted in ``wide_launch_counts``, by precision, besides the
wrapper's count).  Within its fast plan the f32 phase A shares each read's
h1 across a group of lanes where the widths allow it (the library's
``read_prob_lane_group()``; its launches counted in
``grouped_launch_count``).  Each library is loaded, and what it reports
of its plan read, once per process (``_native.library``); the wrappers
count and choose from that handle.

The k-mer ids must lie in [0, V) (the kernels read the embedding table
with them unchecked).  The kernels read int8 ids where every id is below
128 (the data's 66 k-mers always are) and int16 ids otherwise, each from a
library of its own.  By default the wrappers check the tensor on its
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

import functools
import types
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.blocks import BN_EPS, KmerMultipleEmbedding, Linear
from ..utils.profiling import span
from . import _native, site_ops
from ._native import TC_CONFIG_KEYS, TC_MODES  # noqa: F401  (read_prob_tc.cu names fused_infer_kernel.TC_CONFIG_KEYS)

# launches of the CUDA kernels in this process, by wrapper: one per
# fused_inference_t / fused_inference call on CUDA tensors (any precision),
# one per launch of phase B (site_reduce_kernel), and one per launch of
# read_prob_tc.cu, by precision
launch_count = 0
fused_inference_launch_count = 0
site_reduce_launch_count = 0
tc_launch_counts = {"f32x3": 0, "bf16": 0}
# launches of a phase A of the wide plan (read_prob_wide_kernel in f32,
# read_prob_tc_wide_kernel in the reduced modes), by precision, by every
# wrapper that launches one
wide_launch_counts = {"f32": 0, "f32x3": 0, "bf16": 0}
# launches of an f32 phase A whose plan shares h1 across lane groups
# (read_prob_lane_group() > 1), by every wrapper that launches one, the
# torch backend's per-read tail among them
grouped_launch_count = 0

VOCAB = 66  # the data's k-mer vocabulary (constants.KMER_TO_INT: 5-mers near a DRACH centre)
PRECISIONS = ("f32", "f32x3", "bf16")
# shared memory one block may opt into on sm_90 (bytes)
SHARED_LIMIT_BYTES = 232448
# the largest vocabulary of the int16 k-mer ids, and the most inputs a read
# may have: the widest read the kernels' plans are held to (the wide plans
# take a read's inputs in steps, tests/test_torch_widths.py checks their
# plans up to this edge; it was a warp's inputs in a block's shared memory
# when the wide plans first ran)
MAX_VOCAB = 32767
MAX_N_IN = SHARED_LIMIT_BYTES // (4 * 32)


class Widths(NamedTuple):
    """The widths of the production architecture: ``positions`` k-mer
    positions (3 signal features each), an embedding of ``emb`` dimensions
    over ``vocab`` k-mers, then Linear(n_in -> hidden1) and
    Linear(hidden1 -> hidden2)."""

    positions: int = 3
    emb: int = 2
    hidden1: int = 150
    hidden2: int = 32
    vocab: int = VOCAB

    @property
    def features(self) -> int:
        return 3 * self.positions

    @property
    def n_in(self) -> int:
        return self.features + self.positions * self.emb


# the released models' widths: the kernels' sources default to them
PRODUCTION = Widths()


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def f32_layout(w: Widths) -> Mapping[str, int]:
    """The f32 weight image of csrc/fused_infer.cu (floats), by the .cu's
    constant names: W1B [H1][kW1Stride] (row k: W1'[k, :n_in], b1'[k],
    zeros), EMB [V][E] padded to kEmbWords, W2 [H1][kH2Pad] (row k: hidden
    unit k's fan-out, zero past H2), B2 and W3 [kH2Pad], B3 and zeros to a
    multiple of 4.  Made once per widths."""
    stride, h2_pad, emb_words = _up(w.n_in + 1, 4), _up(w.hidden2, 4), _up(w.vocab * w.emb, 4)
    lay = {"kW1Stride": stride, "kH2Pad": h2_pad, "kEmbWords": emb_words, "kOffW1B": 0}
    lay["kOffEmb"] = w.hidden1 * stride
    lay["kOffW2"] = lay["kOffEmb"] + emb_words
    lay["kOffB2"] = lay["kOffW2"] + w.hidden1 * h2_pad
    lay["kOffW3"] = lay["kOffB2"] + h2_pad
    lay["kOffB3"] = lay["kOffW3"] + h2_pad
    lay["kWeights"] = lay["kOffB3"] + 4
    return types.MappingProxyType(lay)


@functools.lru_cache(maxsize=None)
def tc_layout(w: Widths) -> Mapping[str, int]:
    """The tensor-core image of csrc/read_prob_tc.cu (32-bit words), by the
    .cu's constant names.  Hidden units are padded with zero weights and
    zero bias, H1 to a multiple of 16 (kH1Pad: layer 2's kKSteps k16 steps,
    layer 1's kTiles1 n8 tiles) and H2 to a multiple of 8 (kH2Pad, kTiles2);
    bf16's layer 1 takes kK1Steps k16 steps over the n_in inputs; W1T,
    f32x3's layer 1 input-major for the wide plan, closes the image.  Made
    once per widths."""
    h1_pad, h2_pad = _up(w.hidden1, 16), _up(w.hidden2, 8)
    stride, emb_words = _up(w.n_in + 1, 4), _up(w.vocab * w.emb, 4)
    lay = {
        "kH1Pad": h1_pad, "kKSteps": h1_pad // 16, "kTiles1": h1_pad // 8, "kH2Pad": h2_pad,
        "kTiles2": h2_pad // 8, "kW1Stride": stride, "kW1Quads": stride // 4, "kK1Steps": _up(w.n_in, 16) // 16,
        "kEmbWords": emb_words, "kTcOffW1F": 0,
    }
    lay["kTcOffEmbX"] = lay["kTcOffW1F"] + lay["kKSteps"] * 4 * stride * 4
    lay["kTcOffW3L"] = lay["kTcOffEmbX"] + emb_words
    lay["kTcOffW2L"] = lay["kTcOffW3L"] + h2_pad
    lay["kTcOffW2H"] = lay["kTcOffW2L"] + lay["kKSteps"] * lay["kTiles2"] * 64
    lay["kTcOffB2"] = lay["kTcOffW2H"] + lay["kKSteps"] * lay["kTiles2"] * 64
    lay["kTcOffW3H"] = lay["kTcOffB2"] + h2_pad
    lay["kTcOffB3"] = lay["kTcOffW3H"] + h2_pad
    lay["kTcOffW1H"] = lay["kTcOffB3"] + 4
    lay["kTcOffB1"] = lay["kTcOffW1H"] + lay["kK1Steps"] * lay["kTiles1"] * 64
    lay["kTcOffEmbH"] = lay["kTcOffB1"] + h1_pad
    lay["kTcOffW1T"] = lay["kTcOffEmbH"] + emb_words
    lay["kTcWords"] = lay["kTcOffW1T"] + (w.n_in + 1) * h1_pad
    return types.MappingProxyType(lay)


def kernel_limit(w: Widths) -> Optional[str]:
    """None when the CUDA kernels take the widths ``w``, else the limit
    that binds, in words: a vocabulary past ``MAX_VOCAB`` (the int16 ids),
    or more than ``MAX_N_IN`` inputs a read (P (3 + E), past 1,816)."""
    if min(w) < 1:
        return "every width must be at least 1"
    if w.vocab > MAX_VOCAB:
        return f"the kernels read int16 k-mer ids: a vocabulary of at most {MAX_VOCAB}, not {w.vocab}"
    if w.n_in > MAX_N_IN:
        return f"the kernels' plans are held to n_in <= {MAX_N_IN} inputs a read, not {w.n_in}"
    return None


def kernel_defines(w: Widths, id_bytes: int = 1) -> Dict[str, int]:
    """The ``-D`` defines that build the kernels for ``w`` and k-mer ids of
    ``id_bytes`` bytes (1: int8, 2: int16): none at the production widths
    and int8 ids (the sources' defaults), else the widths, from which the
    sources derive their tiling, and the id width where it is 2."""
    if id_bytes not in (1, 2):
        raise ValueError(f"k-mer ids of 1 or 2 bytes, not {id_bytes}")
    defines = {} if w == PRODUCTION else {
        "M6A_POS": w.positions, "M6A_EMB": w.emb, "M6A_VOCAB": w.vocab, "M6A_H1": w.hidden1, "M6A_H2": w.hidden2}
    if id_bytes == 2:
        defines["M6A_KMER_ID_BYTES"] = 2
    return defines


def widths_config(w: Widths) -> dict:
    """The packaged ``m6anet.toml`` (the production architecture) at widths
    ``w``, as the dict ``MILModel`` and ``train --model_config`` take: the
    model a user retrains at other widths.  P must be odd (2n + 1 for n
    neighbouring positions on each side)."""
    import copy
    import tomllib

    from ..constants import DEFAULT_MODEL_CONFIG

    if w.positions % 2 != 1:
        raise ValueError(f"positions must be odd (2n + 1), got {w.positions}")
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        config = copy.deepcopy(tomllib.load(f))
    deagg, emb, _, l1, l2, pool = config["block"]
    deagg["num_neighboring_features"] = emb["num_neighboring_features"] = w.positions // 2
    emb["input_channel"], emb["output_channel"] = w.vocab, w.emb
    l1["input_channel"], l1["output_channel"] = w.n_in, w.hidden1
    l2["input_channel"], l2["output_channel"] = w.hidden1, w.hidden2
    pool["input_channel"] = w.hidden2
    return config


class FusedParamsT(NamedTuple):
    """Transposed parameter set (the JAX package's ``FusedEncoderParamsT``)
    plus the packed weight images the CUDA kernels stage in shared memory,
    and the widths they were packed for."""

    w1t: torch.Tensor  # (H1, n_in) BN-folded first linear
    embt: torch.Tensor  # (E, V) embedding, transposed
    b1t: torch.Tensor  # (H1, 1)
    w2t: torch.Tensor  # (H2, H1)
    b2t: torch.Tensor  # (H2, 1)
    w3t: torch.Tensor  # (1, H2)
    b3t: torch.Tensor  # (1, 1)
    packed: torch.Tensor  # f32, f32_layout(widths), documented in csrc/fused_infer.cu
    tc: torch.Tensor  # int32 words, tc_layout(widths), documented in csrc/read_prob_tc.cu
    widths: Widths = PRODUCTION


def pack_f32(w: Widths, w1t, embt, b1t, w2t, b2t, w3t, b3t) -> torch.Tensor:
    lay = f32_layout(w)
    image = w1t.new_zeros(lay["kWeights"])
    w1b = image[: w.hidden1 * lay["kW1Stride"]].view(w.hidden1, lay["kW1Stride"])
    w1b[:, : w.n_in] = w1t
    w1b[:, w.n_in] = b1t[:, 0]
    image[lay["kOffEmb"] : lay["kOffEmb"] + w.vocab * w.emb] = embt.t().reshape(-1)
    w2 = image[lay["kOffW2"] : lay["kOffB2"]].view(w.hidden1, lay["kH2Pad"])
    w2[:, : w.hidden2] = w2t.t()  # row k: hidden unit k's fan-out
    image[lay["kOffB2"] : lay["kOffB2"] + w.hidden2] = b2t.reshape(-1)
    image[lay["kOffW3"] : lay["kOffW3"] + w.hidden2] = w3t.reshape(-1)
    image[lay["kOffB3"]] = b3t.reshape(-1)[0]
    return image


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


def _pack_tc(w: Widths, w1t, embt, b1t, w2t, b2t, w3t, b3t) -> torch.Tensor:
    """The tensor-core kernel's image at widths ``w`` (``tc_layout``):
    layer 1 of f32x3 in the order its lanes read it (lane t of a quad
    computes 4 units a k step), and each ``wgmma`` B operand in the
    canonical K-major layout without swizzle."""
    lay = tc_layout(w)
    h1_pad, h2_pad, steps, k1 = lay["kH1Pad"], lay["kH2Pad"], lay["kKSteps"], lay["kK1Steps"]
    stride = lay["kW1Stride"]
    w1b = w1t.new_zeros(h1_pad, stride)  # row u: W1'[u, :n_in], b1'[u], zeros
    w1b[: w.hidden1, : w.n_in] = w1t
    w1b[: w.hidden1, w.n_in] = b1t[:, 0]
    j, c, t = torch.meshgrid(torch.arange(steps), torch.arange(4), torch.arange(4), indexing="ij")
    unit = 16 * j + 2 * t + (c & 1) + 8 * (c >> 1)  # the 4 units lane t computes in k step j
    w1f = w1b.view(h1_pad, stride // 4, 4)[unit].permute(0, 1, 3, 2, 4)  # [j][c][q][t][4]

    # B (n x k16): core matrices of 8 n x 8 k, the two k halves of a k16
    # step side by side, then the groups of 8 n, then the k steps
    w1k = w1t.new_zeros(h1_pad, 16 * k1)  # columns past n_in are zero, never the bias
    w1k[: w.hidden1, : w.n_in] = w1t
    w1h = w1k.reshape(lay["kTiles1"], 8, k1, 2, 8).permute(2, 0, 3, 1, 4)  # [step][n group][k half][n][k]
    w2k = w2t.new_zeros(h2_pad, h1_pad)
    w2k[: w.hidden2, : w.hidden1] = w2t
    w2 = w2k.reshape(lay["kTiles2"], 8, steps, 2, 8).permute(2, 0, 3, 1, 4)  # [step][n group][k half][n][k]
    w2_hi, w2_lo = bf16_split(w2)
    emb = embt.t().reshape(-1)
    emb_hi, emb_lo = bf16_split(emb)
    w3_hi, w3_lo = bf16_split(w3t.reshape(-1))

    def words(f32: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
        f32 = f32.reshape(-1)
        if n is not None:  # zero padding to n words
            f32 = torch.cat([f32, f32.new_zeros(n - f32.numel())])
        return f32.contiguous().view(torch.int32)

    parts = [
        words(w1f),  # W1F
        words(emb_hi + emb_lo, lay["kEmbWords"]),  # EMBX
        words(w3_lo, h2_pad),  # W3L
        _bf16x2_words(w2_lo.reshape(-1, 2)),  # W2L
        _bf16x2_words(w2_hi.reshape(-1, 2)),  # W2H
        words(b2t, h2_pad),  # B2
        words(w3_hi, h2_pad),  # W3H
        words(b3t, 4),  # B3, zero padding
        _bf16x2_words(w1h.reshape(-1, 2)),  # W1H
        words(b1t, h1_pad),  # B1
        words(bf16_round(emb), lay["kEmbWords"]),  # EMBH
        words(w1b[:, : w.n_in + 1].t()),  # W1T [input, then the bias][unit]
    ]
    image = torch.cat(parts).contiguous()
    assert image.numel() == lay["kTcWords"]
    return image


def model_tensors(model: nn.Module) -> Tuple[Widths, Dict[str, torch.Tensor]]:
    """The widths of a model of the production architecture and its
    parameters as the kernels take them: eval BatchNorm folded into the
    first linear layer, every tensor an f32 copy detached from the model."""
    widths = model_widths(model)
    emb = next(b for b in model.blocks if isinstance(b, KmerMultipleEmbedding)).embedding.weight
    l1, l2 = [b for b in model.blocks if isinstance(b, Linear)]
    head = model.pooling.linear

    def f32(t: torch.Tensor) -> torch.Tensor:  # a copy, detached from the model
        return t.detach().float().clone()

    w1, b1 = f32(l1.linear.weight), f32(l1.linear.bias)  # (H1, n_in), (H1,)
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
    h1, h2 = widths.hidden1, widths.hidden2
    expected = dict(
        w1t=(h1, widths.n_in), embt=(widths.emb, widths.vocab), b1t=(h1, 1), w2t=(h2, h1), b2t=(h2, 1),
        w3t=(1, h2), b3t=(1, 1),
    )
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"fused kernel expects {name} of shape {shape}, got {tuple(tensors[name].shape)}")
    return widths, tensors


def model_widths(model: nn.Module) -> Widths:
    """The widths of a model of the production architecture, read from
    its parameters' shapes."""
    emb_block = next(b for b in model.blocks if isinstance(b, KmerMultipleEmbedding))
    vocab, emb = emb_block.embedding.weight.shape
    l1, l2 = [b for b in model.blocks if isinstance(b, Linear)]
    return Widths(emb_block.n_positions, emb, l1.linear.weight.shape[0], l2.linear.weight.shape[0], vocab)


def prepare_fused_params_t(model: nn.Module) -> FusedParamsT:
    """Fold eval BatchNorm into the first linear layer and lay the weights
    out for the kernels at the model's widths, on the model's device.  The
    model must have the production architecture
    (``engine.production_architecture``); the plain versions take any
    widths, the kernels all but those ``kernel_limit`` names, which the
    engine checks before it launches."""
    widths, tensors = model_tensors(model)
    tc = _pack_tc(widths, **{name: t.cpu() for name, t in tensors.items()}).to(tensors["w1t"].device)
    return FusedParamsT(**tensors, packed=pack_f32(widths, **tensors), tc=tc, widths=widths)


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
    """``v @ w`` (v (N, H2), w (H2,)) in the order of read_prob_tc.cu's
    head: lane t of a quad takes units 8 nt + 2t + e (nt, then e, in order)
    with ``fmaf`` from 0, and the quad adds its four sums as
    (t0 + t1) + (t2 + t3) (two xor shuffles).  The kernel's padded units
    past H2 add fmaf(0, 0, acc), which leaves acc as it is."""
    lanes = []
    for t in range(4):
        acc = v.new_zeros(v.shape[0])
        for nt in range(-(-w.shape[0] // 8)):
            for e in range(2):
                n = 8 * nt + 2 * t + e
                if n < w.shape[0]:
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
    f32x3's cross products and bf16's layer 1, whose k16 steps take one
    accumulator, ``_tensor_core_accumulate``).  Any widths: a k16 chunk past
    H1 or n_in holds the kernel's zero padding."""
    check_precision(precision)
    _check_kmer_range(kmer_ids, vocab=fp.widths.vocab)
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
        cross = h.new_zeros(n, fp.w2t.shape[0])
        for k in range(0, fp.w2t.shape[1], 16):  # W2lo.h1hi, then W2hi.h1lo, a k16 step at a time
            ks = slice(k, k + 16)
            cross = _tensor_core_accumulate(cross, h_hi[:, ks], w2_lo[:, ks])
            cross = _tensor_core_accumulate(cross, h_lo[:, ks], w2_hi[:, ks])
        h = torch.relu((cross + _tensor_core_matmul(h_hi, w2_hi)) + b2)
        v_hi, v_lo = bf16_split(h)
        w3_hi, w3_lo = bf16_split(fp.w3t.reshape(-1))
        z = ((_lane_dot(v_hi, w3_lo) + _lane_dot(v_lo, w3_hi)) + _lane_dot(v_hi, w3_hi)) + b3
    else:
        h1 = _tensor_core_accumulate(x.new_zeros(n, fp.w1t.shape[0]), bf16_round(x), bf16_round(fp.w1t))
        h = torch.relu(h1 + b1)
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


def kernel_lib(widths: Widths = PRODUCTION, id_bytes: int = 1, precision: str = "f32") -> _native.Library:
    """The library whose phase A ``precision`` launches (csrc/fused_infer.cu,
    with phase B, in f32; csrc/read_prob_tc.cu in f32x3 and bf16) at
    ``widths`` and ``id_bytes``-byte k-mer ids, loaded once; raises
    (``check_widths``) for widths the kernels do not take."""
    check_precision(precision)
    check_widths(widths)
    return _native.library("fused_infer" if precision == "f32" else "read_prob_tc", kernel_defines(widths, id_bytes))


def phase_a_wide(precision: str, widths: Widths = PRODUCTION, id_bytes: int = 1) -> bool:
    """Whether phase A of ``precision`` takes its wide plan at ``widths``
    and k-mer ids of ``id_bytes`` bytes (read_prob_wide_kernel in f32,
    read_prob_tc_wide_kernel in f32x3 and bf16), as the source's plan
    decides it; builds the kernel if needed."""
    return bool(kernel_lib(widths, id_bytes, precision).plan[precision]["wide"])


def phase_a_kernel(precision: str, widths: Widths = PRODUCTION, id_bytes: int = 1) -> str:
    """The name of the kernel phase A of ``precision`` launches at
    ``widths`` and k-mer ids of ``id_bytes`` bytes (a part of its mangled
    name, as ``_build.ptxas_usage`` takes it)."""
    wide = phase_a_wide(precision, widths, id_bytes)
    if precision == "f32":
        return "read_prob_wide_kernel" if wide else "read_prob_kernelILi"
    return f"read_prob_tc{'_wide' if wide else ''}_kernelILi{TC_MODES[precision]}E"


def check_widths(widths: Widths) -> None:
    """Raise unless the CUDA kernels take ``widths`` (``kernel_limit``)."""
    limit = kernel_limit(widths)
    if limit is not None:
        raise ValueError(
            f"the CUDA kernels do not take this model's widths (positions {widths.positions}, embedding "
            f"{widths.emb} over {widths.vocab} k-mers, hidden {widths.hidden1} -> {widths.hidden2}): {limit}; "
            "run it with --backend torch"
        )


def read_tile_reads(precision: str = "f32", widths: Widths = PRODUCTION) -> int:
    """Reads phase A takes per tile (f32: threads per block x reads per
    thread; the reduced modes: the 64-read tiles of one consumer
    warpgroup's item, which differ by mode, or a warp's 16 in the wide
    plan); builds the kernel if needed."""
    return kernel_lib(widths, precision=precision).plan[precision]["tile_reads"]


def launch_read_prob_tc(fp: FusedParamsT, features: torch.Tensor, kmer_ids: torch.Tensor,
                        p: torch.Tensor, precision: str) -> None:
    """Launch the tensor-core phase A of ``precision`` ("f32x3" or "bf16")
    into ``p`` on the current stream, on inputs that check_read_inputs has
    checked for ``precision``, and count the launch."""
    lib = kernel_lib(fp.widths, kmer_ids.element_size(), precision)
    _native.launch(lib, "read_prob_tc_launch", "ops.launch.read_prob_tc", features.device, features.data_ptr(),
                   kmer_ids.data_ptr(), fp.tc.data_ptr(), p.data_ptr(), features.shape[0], TC_MODES[precision])
    tc_launch_counts[precision] += 1
    count_wide(lib, precision, features.shape[0])


def count_wide(lib: _native.Library, precision: str, n_reads: int) -> None:
    """Count a launch of ``lib``'s phase A of ``precision`` over ``n_reads``
    reads in ``wide_launch_counts`` where its plan is wide (no read, no
    launch)."""
    if n_reads > 0 and lib.plan[precision]["wide"]:
        wide_launch_counts[precision] += 1


def count_grouped(lib: _native.Library, n_reads: int) -> None:
    """Count a launch of the f32 phase A of ``lib`` (a csrc/fused_infer.cu
    library) over ``n_reads`` reads in ``grouped_launch_count`` where its
    plan takes lane groups (no read, no launch)."""
    global grouped_launch_count
    if n_reads > 0 and lib.lane_group > 1:
        grouped_launch_count += 1


def ragged_tail_batches(tile: int, seed: int = 1, widths: Widths = PRODUCTION):
    """``pack_sites`` batches whose read counts end phase A's tile of
    ``tile`` reads raggedly: 1, 2, 3, 255, 257, tile - 1, tile + 1 and 4097
    reads.  Each is sites of 1 to 8 reads, then n // 8 padding reads and two
    padding sites, as numpy ``(features, kmer_ids, offsets, counts)`` drawn
    from ``seed``, with the reads of ``widths`` (k-mer ids over the whole
    vocabulary: int8, or int16 past 128 k-mers): the cases on which the
    card tests and ``chip_smoke.py`` hold the kernel against its plain
    version."""
    rng = np.random.default_rng(seed)
    batches = []
    for n in sorted({1, 2, 3, 255, 257, tile - 1, tile + 1, 4097}):
        counts, left = [], n - n // 8
        while left > 0:
            counts.append(min(left, int(rng.integers(1, 9))))
            left -= counts[-1]
        counts = np.array(counts + [0, 0], np.int32)
        offsets = np.where(counts > 0, np.cumsum(counts) - counts, 0).astype(np.int32)
        features = rng.normal(size=(n, widths.features)).astype(np.float32)
        kmer_ids = rng.integers(0, widths.vocab, size=(n, widths.positions)).astype(kmer_dtype(widths.vocab))
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


def kmer_dtype(vocab: int):
    """The numpy type of k-mer ids below ``vocab``: int8 up to 128 k-mers,
    else int16."""
    return np.int8 if vocab <= 128 else np.int16


class CheckedKmerIds(NamedTuple):
    """Host k-mer ids (N, P), int8 or int16, whose range
    :func:`checked_kmer_ids` has checked, [0, ``vocab``): what a wrapper's
    ``host_kmer_ids`` takes."""

    ids: np.ndarray
    vocab: int = VOCAB


def checked_kmer_ids(kmer_ids: np.ndarray, vocab: int = VOCAB) -> CheckedKmerIds:
    """Check host k-mer ids for the range [0, vocab) on the host and
    return them marked as checked, as int8 where every id is below 128 and
    as int16 otherwise (the types the kernels read); raise ValueError on
    any other id.  An int8 array takes one pass as uint8, where negative
    ids read as >= 128; wider ids are checked before they are narrowed."""
    ids = np.asarray(kmer_ids)
    if not np.issubdtype(ids.dtype, np.integer):
        raise ValueError(f"kmer_ids must be integers, got {ids.dtype}")
    if ids.dtype == np.int8:
        bad, top = ids.size > 0 and int(ids.view(np.uint8).max()) >= vocab, 0
    else:
        top = int(ids.max()) if ids.size else 0
        bad = ids.size > 0 and (int(ids.min()) < 0 or top >= vocab)
    if bad:
        raise ValueError(f"kmer_ids must lie in [0, {vocab})")
    return CheckedKmerIds(ids.astype(np.int8 if top < 128 else np.int16, copy=False), vocab)


def check_host_kmer_ids(host_kmer_ids: CheckedKmerIds, kmer_ids: torch.Tensor, vocab: int = VOCAB) -> None:
    """Raise unless ``host_kmer_ids`` is checked_kmer_ids' result for an
    array of ``kmer_ids``' shape, checked against at most ``vocab``."""
    if not isinstance(host_kmer_ids, CheckedKmerIds):
        raise TypeError("host_kmer_ids must be what checked_kmer_ids returns")
    if host_kmer_ids.ids.shape != tuple(kmer_ids.shape):
        raise ValueError(
            f"host_kmer_ids have shape {host_kmer_ids.ids.shape}, expected {tuple(kmer_ids.shape)} like kmer_ids"
        )
    if host_kmer_ids.vocab > vocab:
        raise ValueError(f"host_kmer_ids were checked for [0, {host_kmer_ids.vocab}), the model takes [0, {vocab})")


def _check_kmer_range(
    kmer_ids: torch.Tensor, bad_site_ids: Optional[torch.Tensor] = None, vocab: int = VOCAB
) -> bool:
    """Raise on a k-mer id outside [0, vocab) (pack_sites never makes one
    for the data's 66 k-mers) and, given ``bad_site_ids`` (a 0-d bool
    tensor), on site ids off the dense layout, on either device; on the
    card this waits for the checks' results, in one host sync.  Returns
    whether an id is 128 or more (the kernels then read int16 ids).  A
    bound past the ids' type is no test (torch compares in that type)."""
    top = torch.iinfo(kmer_ids.dtype).max
    bad = (kmer_ids < 0) | (kmer_ids >= vocab) if vocab <= top else kmer_ids < 0
    wide = (kmer_ids >= 128).any() if top >= 128 else torch.zeros((), dtype=torch.bool, device=kmer_ids.device)
    flags = [bad.any(), wide]
    if bad_site_ids is not None:
        flags.append(bad_site_ids)
    bad_kmer, wide, *bad_ids = torch.stack(flags).tolist()
    if bad_kmer:
        raise ValueError(f"kmer_ids must lie in [0, {vocab})")
    if any(bad_ids):
        raise ValueError(SITE_IDS_ERROR)
    return bool(wide)


def fused_inference_t(
    fp: FusedParamsT,
    features: torch.Tensor,  # (N, 3P) f32
    kmer_ids: torch.Tensor,  # (N, P) int8, int16 or int32
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
    counts) and ignore ``site_ids``.  The kernels read int8 k-mer ids, or
    int16 where an id is 128 or more: wider ids are checked and narrowed
    first.  ``host_kmer_ids``
    (:func:`checked_kmer_ids` of the array ``kmer_ids`` was copied from)
    replaces the check on the device, and its host sync."""
    global launch_count
    with span("ops.fused_inference_t"):
        check_precision(precision)
        if features.device.type == "cpu":
            if host_kmer_ids is not None:
                with span("ops.check"):
                    check_host_kmer_ids(host_kmer_ids, kmer_ids, fp.widths.vocab)
            return fused_inference_t_plain(
                fp, features, kmer_ids, site_ids, offsets, counts, threshold, n_samples, precision
            )
        out = _launch_fused(
            fp, features, kmer_ids, offsets, counts, threshold, n_samples, "fused_inference_t", precision,
            host_kmer_ids=host_kmer_ids,
        )
        launch_count += 1
        return out


def check_read_inputs(
    fp: FusedParamsT,
    features: torch.Tensor,
    kmer_ids: torch.Tensor,
    name: str,
    bad_site_ids: Optional[torch.Tensor] = None,
    host_kmer_ids: Optional[CheckedKmerIds] = None,
    precision: str = "f32",
) -> torch.Tensor:
    """Check the per-read inputs of a kernel launch in ``precision``, the
    weight image it reads among them (and ``bad_site_ids``, in the same
    host sync); return the k-mer ids as the kernel reads them:
    int8, or int16 where an id is 128 or more.  Given ``host_kmer_ids``
    the caller checked the ids' range on the host, so only their type and
    shape are checked here (``check_host_kmer_ids``), the host ids' type
    decides, and nothing waits for the device."""
    if host_kmer_ids is not None:
        check_host_kmer_ids(host_kmer_ids, kmer_ids, fp.widths.vocab)
    if features.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {features.device}")
    w = fp.widths
    device, n = features.device, features.shape[0]
    check_tensor("features", features, (torch.float32,), (n, w.features), device)
    check_tensor("kmer_ids", kmer_ids, (torch.int8, torch.int16, torch.int32), (n, w.positions), device)
    check_tensor("fp.packed", fp.packed, (torch.float32,), (f32_layout(w)["kWeights"],), device)
    if precision != "f32":
        check_tensor("fp.tc", fp.tc, (torch.int32,), (tc_layout(w)["kTcWords"],), device)
    if host_kmer_ids is None:
        wide = _check_kmer_range(kmer_ids, bad_site_ids, w.vocab)
    else:
        wide = host_kmer_ids.ids.dtype != np.int8
    return kmer_ids.to(torch.int16 if wide else torch.int8)


def _launch_fused(fp, features, kmer_ids, offsets, counts, threshold, n_samples, name, precision,
                  bad_site_ids=None, host_kmer_ids=None):
    """Check the inputs and launch both phases: fused_infer.cu's in f32; in
    a reduced mode read_prob_tc.cu's phase A, then fused_infer.cu's phase
    B."""
    global site_reduce_launch_count
    device = features.device
    n, n_sites = features.shape[0], counts.shape[0]
    with span("ops.check"):
        if device.type == "cuda":
            check_tensor("offsets", offsets, (torch.int32,), (n_sites,), device)
            check_tensor("counts", counts, (torch.int32,), (n_sites,), device)
        if n_samples < 0:
            raise ValueError(f"n_samples must be >= 0, got {n_samples}")
        kmer_ids = check_read_inputs(fp, features, kmer_ids, name, bad_site_ids, host_kmer_ids, precision)

    p = torch.empty(n, dtype=torch.float32, device=device)
    site_p = torch.empty(n_sites, dtype=torch.float32, device=device)
    mod_ratio = torch.empty(n_sites, dtype=torch.float32, device=device)
    if precision != "f32":
        launch_read_prob_tc(fp, features, kmer_ids, p, precision)
        launch_site_reduce(p, offsets, counts, threshold, n_samples, site_p, mod_ratio)
    else:
        lib = kernel_lib(fp.widths, kmer_ids.element_size())
        _native.launch(lib, "fused_infer_launch", "ops.launch.fused_infer", device, features.data_ptr(),
                       kmer_ids.data_ptr(), offsets.data_ptr(), counts.data_ptr(), fp.packed.data_ptr(), p.data_ptr(),
                       site_p.data_ptr(), mod_ratio.data_ptr(), n, n_sites, float(threshold), int(n_samples))
        count_wide(lib, "f32", n)
        count_grouped(lib, n)
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
    with span("ops.site_reduce"):
        if p.device.type == "cpu":
            return site_reduce_plain(p, offsets, counts, threshold, n_samples)
        if p.device.type != "cuda":
            raise ValueError(f"site_reduce runs on cpu or cuda, got {p.device}")
        n_sites = counts.shape[0]
        with span("ops.check"):
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
    _native.launch(kernel_lib(), "site_reduce_launch", "ops.launch.site_reduce", p.device, p.data_ptr(),
                   offsets.data_ptr(), counts.data_ptr(), site_p.data_ptr(), mod_ratio.data_ptr(), p.shape[0],
                   n_sites, float(threshold), int(n_samples))
    site_reduce_launch_count += 1


# p values at the edges of phase B's exact sums: 1 - p is a whole number of
# 2^-24 units for each, from 2^24 (p = 0) down to 0 (p = 1)
PHASE_B_EDGES = np.array([0.0, 2.0**-149, 2.0**-25, 0.5 - 2.0**-25, 0.5, 1 - 2.0**-24, 1.0], np.float32)


def site_reduce_batch(seed: int = 3, nan_reads: bool = True):
    """``(p, offsets, counts)`` (numpy) on which the card tests and
    ``chip_smoke.py`` hold phase B alone against its plain version: sites of
    1, 20-1,000 and 57,344 reads (``mc_kernel.MAX_STAGED_READS``), count-0
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
    features: torch.Tensor,  # (N, 3P) f32
    kmer_ids: torch.Tensor,  # (N, P) int8, int16 or int32
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
