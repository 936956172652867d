"""What the on-card sweeps of the kernel sources share.

* :func:`production_batch` makes the production batch every sweep and
  ``chip_smoke.py`` time on;
* :func:`variant_source` rewrites ``constexpr int`` constants of a source;
* :func:`same_bits` compares two kernels' outputs bit for bit;
* :func:`sass_instructions` and :func:`sass_counts` read a kernel's static
  SASS with ``cuobjdump``;
* :func:`smi` queries ``nvidia-smi``, :func:`max_sm_hz` reads the SM
  clock's maximum;
* :func:`time_interleaved` times launches with CUDA events, the L2 cache
  flushed before each one, in two rounds (the second in reverse order);
* :func:`gather_passes`, :func:`draw_window` and :func:`issue_floor_ms`
  give the floors of ``mc.cu``'s design that ``sweep_mc.py`` and
  ``chip_smoke.py`` print beside its times.  They are models of the
  kernel, counted from the batch and the SASS, not measurements.
"""
from __future__ import annotations

import collections
import os
import re
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build

FLUSH_BYTES = 1 << 30  # zeroed before each timed launch: well past the 50 MB L2
BANKS = 32  # shared-memory banks of an SM
READS, SITES = 1 << 20, 16384  # the production batch: the JAX engine's accelerator capacities


def production_batch(seed: int = 0):
    """The production batch, as numpy ``(features, kmer_ids, offsets,
    counts)``: ``READS`` reads and ``SITES`` sites packed back to back from
    read 0 as ``pack_sites`` packs them, read counts from the HEK293T-shaped
    law of ``bench.py``, ``clip(gamma(2, 30), 20, 1000)`` (mean ~60, so all
    16,384 sites are real and ~1M reads), padding reads after the last site.
    Features are N(0, 1), k-mer ids uniform over the 66; drawn in that
    order from ``seed``."""
    rng = np.random.default_rng(seed)
    features = rng.normal(size=(READS, 9)).astype(np.float32)
    kmer_ids = rng.integers(0, 66, size=(READS, 3)).astype(np.int8)
    counts = np.clip(rng.gamma(2.0, 30.0, size=SITES), 20, 1000).astype(np.int32)
    if int(counts.sum()) > READS:
        raise ValueError("the production batch's read counts overflow its reads")
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    return features, kmer_ids, offsets, counts


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits at every element of two f32 tensors, any NaN taken as
    any NaN."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and torch.equal(a[~nan_a].view(torch.int32), b[~nan_b].view(torch.int32))


def variant_source(text: str, names: Sequence[str], values: Sequence[int], source_name: str) -> str:
    """``text`` with each ``constexpr int <name> = N;`` set to its value."""
    for name, value in zip(names, values):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{source_name} has no single line 'constexpr int {name} = ...;'")
    return text


def sass_instructions(library: str, kernel: str) -> List[Tuple[str, str, str]]:
    """The static SASS of the kernel whose (mangled) name contains
    ``kernel``, as (opcode, modifiers, operands) in program order, or an
    empty list without cuobjdump."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return []
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True).stdout
    found, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)(\.[A-Z0-9._]*)?([^;]*)", line)
        if inside and op:
            found.append((op.group(1), op.group(2) or "", op.group(3).strip()))
    return found


def sass_counts(
    instructions: Sequence[Tuple[str, str, str]], opcodes: Sequence[str], modifiers: Sequence[str] = ()
) -> Dict[str, int]:
    """Count of each opcode in ``opcodes`` (the mnemonic before its first
    dot), split by the first of ``modifiers`` it carries."""
    counts: collections.Counter = collections.Counter()
    for op, mods, _ in instructions:
        if op in opcodes:
            counts[op + next((m for m in modifiers if m in mods), "")] += 1
    return dict(sorted(counts.items()))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def max_sm_hz() -> float:
    """The SM clock's maximum, in Hz (``nvidia-smi`` gives MHz)."""
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def time_interleaved(launches: Sequence[Callable[[], None]], reps: int) -> Tuple[List[List[float]], List[str]]:
    """CUDA-event times (ms) of each launch: ``reps`` per round after three
    warm-up launches, two rounds (the second in reverse order), the L2 cache
    flushed before each timed launch.  Returns the times of each launch,
    first round first, and the SM clock read after each round."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    times: List[List[float]] = [[] for _ in launches]
    clocks = []
    order = list(range(len(launches)))
    for round_order in (order, order[::-1]):
        for k in round_order:
            launch = launches[k]
            for _ in range(3):
                launch()
            for _ in range(reps):
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                end.record()
                end.synchronize()
                times[k].append(start.elapsed_time(end))
        clocks.append(smi("clocks.sm"))
    return times, clocks


def gather_passes(counts: np.ndarray, u: np.ndarray) -> Tuple[int, int]:
    """(passes, warp-wide gathers) of mc.cu's shared-memory loads over all
    real sites: lanes hold 32 consecutive iterations, a lane reads address
    trunc(U * c) of the site's c + 1 staged values, and a gather takes as
    many passes as the most distinct addresses any one of the 32 banks
    holds."""
    n_samples, n_iters = u.shape
    groups = -(-n_iters // 32)
    gathers = n_samples * groups
    values, n_sites = np.unique(counts[counts > 0], return_counts=True)
    passes = 0
    for c, k in zip(values.tolist(), n_sites.tolist()):
        idx = (u * np.float32(c)).astype(np.int64)  # the f32 product, truncated
        lanes = np.full((n_samples, groups * 32), -1, np.int64)
        lanes[:, :n_iters] = idx
        lanes = lanes.reshape(n_samples, groups, 32)
        width = -(-(c + 1) // BANKS) * BANKS
        hit = np.zeros((n_samples, groups, width), bool)
        j, g, _ = np.nonzero(lanes >= 0)
        hit[j, g, lanes[lanes >= 0]] = True
        passes += k * int(hit.reshape(n_samples, groups, -1, BANKS).sum(axis=2).max(axis=-1).sum())
    return passes, gathers * int(n_sites.sum())


def draw_window(instructions: Sequence[Tuple[str, str, str]]) -> Optional[Dict[str, float]]:
    """The SASS of mc.cu's kernel from the first to the last ``FADD.RZ ...,
    8388608`` (the index of a draw; the unrolled draws lie between them, one
    such FADD.RZ each): instructions per draw, and the LDG, F2I, IMNMX and
    LDS it holds."""
    at = [k for k, (op, mods, operands) in enumerate(instructions)
          if op == "FADD" and ".RZ" in mods and operands.endswith("8388608")]
    if not at:
        return None
    window = [op for op, _, _ in instructions[at[0] : at[-1] + 1]]
    return {
        "instructions_per_draw": len(window) / len(at),
        **{op: window.count(op) for op in ("LDG", "F2I", "IMNMX", "LDS")},
    }


def issue_floor_ms(draws: int, window: Optional[Dict[str, float]], sms: int, hz: float) -> Optional[float]:
    """Time to issue the draws' instructions at four warp instructions a
    clock per SM, from the SASS window's instructions per draw."""
    if window is None:
        return None
    return draws * window["instructions_per_draw"] / (128 * sms * hz) * 1e3
