"""What the on-card sweeps of the kernel sources share.

* :func:`production_batch` makes the production batch every sweep and
  ``chip_smoke.py`` time on, :func:`long_site_shapes` the batches of MC
  sites past the staged cap that ``sweep_mc.py`` and ``chip_smoke.py``
  time the long-site kernel on;
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
  kernel, counted from the batch and the SASS, not measurements;
  :func:`long_site_sectors` counts the bytes of p the long-site kernel's
  bound takes;
* :func:`bind_mc`, :func:`long_site_launcher` and :func:`mc_site_p` call
  a library built from either version of ``mc.cu``: this one, or an older
  one whose long-site launch scans the counts for the long sites (bound
  through ``ops._native``, the one table of the sources' C interfaces).
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import _build, _native
from ..ops import mc_kernel

FLUSH_BYTES = 1 << 30  # zeroed before each timed launch: well past the 50 MB L2
BANKS = 32  # shared-memory banks of an SM
READS, SITES = 1 << 20, 16384  # the production batch: the JAX engine's accelerator capacities
LONG_STRETCH = 18  # sites of MAX_STAGED_READS + 1 reads: the most a batch of READS holds


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


def long_site_shapes(seed: int = 23) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """MC batches with sites past ``mc_kernel.MAX_STAGED_READS``, as numpy
    ``(p, offsets, counts)`` packed from read 0, p uniform in [0, 0.3)
    from ``seed``: one site of 1,000,000 reads; ``LONG_SITE_COUNTS``' three
    sites alone, and after the production batch's 16,384 sites (so that a
    kernel whose work grows with the batch's sites shows it);
    ``LONG_STRETCH`` sites of ``MAX_STAGED_READS + 1`` reads (1,032,210
    reads); one site of ``MAX_SITE_READS`` (2^23 - 1) reads."""
    rng = np.random.default_rng(seed)

    def packed(counts):
        counts = np.asarray(counts, np.int32)
        offsets = (np.cumsum(counts) - counts).astype(np.int32)
        return rng.uniform(0.0, 0.3, size=int(counts.sum())).astype(np.float32), offsets, counts

    long_counts = list(mc_kernel.LONG_SITE_COUNTS)
    return {
        "1M site": packed([long_counts[-1]]),
        "long sites alone": packed(long_counts),
        "production + long sites": packed(np.concatenate([production_batch()[3], long_counts])),
        f"{LONG_STRETCH} x {mc_kernel.MAX_STAGED_READS + 1}": packed([mc_kernel.MAX_STAGED_READS + 1] * LONG_STRETCH),
        "2^23 - 1 site": packed([mc_kernel.MAX_SITE_READS]),
    }


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


def long_site_sectors(offsets: np.ndarray, counts: np.ndarray, u: np.ndarray,
                      long_from: int = mc_kernel.MAX_STAGED_READS) -> int:
    """The 32-byte sectors of p that the draws of the sites past
    ``long_from`` reads touch: each such site's distinct ``(offset + min(
    trunc(U * c), c - 1)) // 8`` over every draw of ``u`` (n_samples,
    n_iters), the f32 product truncated as the kernel takes it, p's first
    value at a sector's start (a CUDA allocation is).  The least that
    ``mc_long_site_kernel`` must read of p: draws that share a sector need
    it once."""
    u = np.asarray(u, np.float32).ravel()
    total = 0
    for offset, c in zip(np.asarray(offsets, np.int64), np.asarray(counts, np.int64)):
        if c > long_from:
            index = np.minimum((u * np.float32(c)).astype(np.int64), c - 1)
            total += len(np.unique((offset + index) // 8))
    return total


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


# mc_long_site_launch of the older mc.cu, before it took a list of the long
# sites: (p, offsets, counts, u, site_p, n_sites, n_reads, n_iters,
# n_samples, long_from, grid, stream), a block a site, at most `grid`
SCAN_LONG_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def mc_lists_sites(source: str) -> bool:
    """Whether the mc.cu at ``source`` takes a list of the long sites
    (this version) rather than scanning the counts (the older one)."""
    with open(source) as f:
        return "const int32_t* long_sites" in f.read()


def bind_mc(lib: Union[str, ctypes.CDLL], lists_sites: bool) -> _native.Library:
    """A library built from an mc.cu (or its path), declared by
    ``_native.open_library``, and its long-site launch by the older
    interface where it scans the counts (not ``lists_sites``)."""
    mc = _native.open_library(lib, "mc")
    if not lists_sites:
        mc.cdll.mc_long_site_launch.argtypes = SCAN_LONG_LAUNCH_ARGTYPES
    return mc


def check_mc(err: int) -> None:
    if err:
        raise RuntimeError(f"an mc.cu launch failed with CUDA error {err}")


def long_site_launcher(lib, lists_sites, p, offsets, counts, u, site_p, n_iters, long_from) -> Callable[[], None]:
    """A call of ``lib``'s (:func:`bind_mc`) long-site launch over the sites
    above ``long_from`` (``u``'s rows the draws an iteration), into
    ``site_p`` on the current stream; it raises where the launch fails.
    Its calls share one scratch (the kernel leaves its tickets zero), so
    that a timed call fills none."""
    n_samples = u.shape[0]
    if lists_sites:
        listed = mc_kernel.long_sites(counts, long_from)
        scratch = mc_kernel.long_scratch(listed.shape[0], n_iters, p.device)
        return lambda: mc_kernel.launch_long_sites(lib, p, offsets, counts, u, site_p, listed, n_iters, n_samples,
                                                   long_from, scratch)
    grid = min(max(int((counts > long_from).sum()), 1), 1024)
    stream = torch.cuda.current_stream().cuda_stream
    # the tensors themselves, not their addresses, in the closure: they
    # live as long as the call does
    return lambda: check_mc(lib.cdll.mc_long_site_launch(
        p.data_ptr(), offsets.data_ptr(), counts.data_ptr(), u.data_ptr(), site_p.data_ptr(), counts.shape[0],
        p.shape[0], n_iters, n_samples, long_from, grid, stream))


def mc_site_p(lib, lists_sites, p, offsets, counts, u, n_iters) -> torch.Tensor:
    """site_p from ``lib`` (:func:`bind_mc`): its staged launch, sized for
    the batch's largest staged count, then its long-site launch after it."""
    site_p = torch.empty(counts.shape[0], dtype=torch.float32, device=p.device)
    staged = torch.where(counts <= mc_kernel.MAX_STAGED_READS, counts, torch.zeros_like(counts))
    check_mc(lib.cdll.mc_site_launch(p.data_ptr(), offsets.data_ptr(), counts.data_ptr(), u.data_ptr(),
                                     site_p.data_ptr(), counts.shape[0], p.shape[0], n_iters, u.shape[0],
                                     int(staged.max()), torch.cuda.current_stream().cuda_stream))
    long_site_launcher(lib, lists_sites, p, offsets, counts, u, site_p, n_iters, mc_kernel.MAX_STAGED_READS)()
    return site_p
