"""Monte-Carlo site probabilities with draws shared by all sites.

The port of ``site_probability_mc_pallas`` in the JAX package's
``ops/mc_kernel.py``: per site with ``c >= 1`` reads,

    site_p = 1 - (1 / n_iters) * sum_t exp(sum_j max(log1p(-p[off + min(floor(U[j, t] * c), c - 1)]), -1e4))

with ``U`` (n_samples, n_iters) from ``random.shared_draws`` (iteration
chunks of ``min(n_iters, 1024)`` columns, chunk ``ci`` drawn from
``fold_in(key, ci)``), the same for every site and every batch, so a site's
value depends only on (seed, its reads) and not on its place in a batch.
Count-0 sites give 0.  A site may hold up to ``MAX_SITE_READS`` (2^23 - 1)
reads on either device, the range of the kernel's draw index.  The kernel
stages a site of up to ``MAX_STAGED_READS`` reads in shared memory, sized at
each launch to the batch's largest such count; a longer site takes a second
kernel of ``csrc/mc.cu``, ``mc_long_site_kernel``, which reads its values
from device memory, spreads each such site's iterations over many blocks
and gives the same site_p bits as the staged kernel would.  It takes the
list of those sites (:func:`long_sites`), so its work does not grow with
the batch's other sites.  ``n_samples`` may be any count from 1: the
kernels hold the draws of an iteration in registers, so each count builds
its own library at first use (``SAMPLES`` = 20, the reference's, is the
sources' default).

On a CUDA tensor :func:`site_probability_mc_cuda` launches the hand-written
Hopper kernel in ``csrc/mc.cu`` and counts the launch in ``launch_count``
(and that of the long-site kernel, where a batch has such sites, in
``long_launch_count``); on a CPU tensor it runs
:func:`site_probability_mc_plain`, the same function in plain PyTorch.  There is no fallback from one to the other.  The kernel
file's header states its bound on the card and its design.

The wrapper checks the sites before it launches (a count above
``MAX_SITE_READS``, a span outside ``p``) and needs the largest staged
count and the number of longer sites.  From the device tensors that costs
a host sync; a caller that holds the same offsets and counts as numpy
arrays (the engine does) passes them as ``host_sites``: the check and the
list run on the host, and the list reaches the card through pinned
memory, with no host sync.  Those arrays must be the exact source of the device tensors.  If they are
not, the kernel still loads and stores nothing outside ``p`` and its staging:
a site whose count exceeds what the launch was sized for, or whose span
leaves ``p``, gives NaN.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from . import _native
from .fused_infer_kernel import check_tensor

# launches of the CUDA kernels in this process: mc_site_kernel, and
# mc_long_site_kernel for the sites above MAX_STAGED_READS
launch_count = 0
long_launch_count = 0

# reads of one site that mc_site_kernel stages: 224 KB of f32 values (with
# the copy of the last one it stages), within the 227 KB of shared memory
# one block may opt into on sm_90
MAX_STAGED_READS = 56 * 1024
# reads of one site: the draw index is exact below 2^23 (csrc/mc.cu)
MAX_SITE_READS = (1 << 23) - 1
# draws per iteration of the sources' default build (kSamples); others build
# at first use
SAMPLES = 20
# elements of the plain version's (n_samples, n_iters, sites) gather per site chunk
_PLAIN_CHUNK = 1 << 24


def _check_sites(offsets, counts, n_reads: int) -> Tuple[int, int]:
    """Raise on a count above ``MAX_SITE_READS`` or a span outside ``p``;
    return the largest count of at most ``MAX_STAGED_READS`` reads (the
    staged sites) and the number of longer sites.  ``offsets`` and ``counts`` are
    tensors (one host sync on the card) or numpy arrays (no device
    access)."""
    if not len(counts):
        return 0, 0
    if isinstance(counts, torch.Tensor):
        real = counts > 0
        outside = real & ((offsets < 0) | (offsets.long() + counts.long() > n_reads))
        staged = torch.where(counts <= MAX_STAGED_READS, counts, torch.zeros_like(counts))
        biggest, largest, n_long, n_outside = torch.stack(
            [counts.max().long(), staged.max().long(), (counts > MAX_STAGED_READS).sum(), outside.sum()]
        ).tolist()
    else:
        offsets, counts = np.asarray(offsets, np.int64), np.asarray(counts, np.int64)
        outside = (counts > 0) & ((offsets < 0) | (offsets + counts > n_reads))
        biggest, n_outside = int(counts.max()), int(outside.sum())
        largest = int(np.where(counts <= MAX_STAGED_READS, counts, 0).max())
        n_long = int((counts > MAX_STAGED_READS).sum())
    if biggest > MAX_SITE_READS:
        raise ValueError(
            f"a site has {biggest} reads, above the {MAX_SITE_READS} (2^23 - 1) the MC kernel's draw index "
            "holds; rerun dataprep with a lower --readcount_max, or use --backend torch"
        )
    if n_outside:
        raise ValueError(f"{n_outside} site spans (offsets, counts) reach outside p")
    return max(largest, 0), n_long


def site_probability_mc_plain(
    p: torch.Tensor,
    offsets: torch.Tensor,
    counts: torch.Tensor,
    u: torch.Tensor,
    n_iters: int,
    n_samples: int = 20,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 gathers and log1p, each
    iteration's draws summed in the order j = 0..n_samples-1 as the kernel
    sums them, the sum over iterations in f64.  Sites are taken in chunks
    so that a full batch fits in memory."""
    if tuple(u.shape) != (n_samples, n_iters):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {(n_samples, n_iters)}")
    _check_sites(offsets, counts, p.shape[0])
    l = torch.clamp(torch.log1p(-p.float()), min=-1e4)
    n_sites = counts.shape[0]
    acc = torch.zeros(n_sites, dtype=torch.float64, device=p.device)
    step = max(1, _PLAIN_CHUNK // max(1, n_samples * n_iters))
    for a in range(0, n_sites, step):
        c = counts[a : a + step]
        base = torch.where(c > 0, offsets[a : a + step], torch.zeros_like(c)).long()
        idx = torch.minimum((u[:, :, None] * c.float()).to(torch.int32), torch.clamp(c - 1, min=0))
        draws = l[base + idx]  # (n_samples, n_iters, sites)
        s = torch.zeros(draws.shape[1:], dtype=torch.float32, device=p.device)
        for j in range(n_samples):
            s = s + draws[j]
        acc[a : a + step] = torch.exp(s).double().sum(dim=0)
    site_p = (1.0 - acc / n_iters).float()
    return torch.where(counts > 0, site_p, torch.zeros_like(site_p))


# the sites ragged_mc_batch(long_sites=True) adds: one read above the
# staged cap, and two far above it
LONG_SITE_COUNTS = (MAX_STAGED_READS + 1, 100_000, 1_000_000)


def ragged_mc_batch(seed: int = 5, long_sites: bool = False):
    """A pack_sites-shaped MC batch ``(p, offsets, counts)`` (numpy) with
    the cases the kernel must take: counts 1, 32, 33 and 64, 65 (around a
    bank's width), 128, 129, 1000, 1024 and 20,000, one at exactly
    ``MAX_STAGED_READS``, a run with counts 1-40, three sites of 25,000 reads
    in a row (more than one block's shared memory holds at once), a site
    whose only read has p = 1 (the -1e4 clamp), count-0 sites between real
    ones and padding sites and reads at the end.  With ``long_sites`` the
    sites of ``LONG_SITE_COUNTS`` follow the others, before the padding
    sites, their reads after the others' and before the padding reads:
    every other site keeps its offset and reads.  Its own seed, so it draws
    nothing from a caller's generator."""
    rng = np.random.default_rng(seed)
    head = [1, 128, 129, 1000, 1024, 0, 20000, 1, 32, 33, 64, 65, MAX_STAGED_READS, 0]
    tail = rng.integers(2, 200, size=200)
    tail[::25] = 0
    body = head + list(range(1, 41)) + [0] + [25000] * 3 + list(tail)
    counts = np.array(body + [0] * 16, np.int32)
    offsets = np.zeros_like(counts)
    offsets[1:] = np.cumsum(counts)[:-1]
    offsets[counts == 0] = 0
    p = rng.uniform(0.0, 0.3, size=int(counts.sum()) + 100).astype(np.float32)
    p[offsets[7]] = 1.0
    if not long_sites:
        return p, offsets, counts
    n_short = int(counts.sum())
    extra = np.array(LONG_SITE_COUNTS, np.int32)
    long_offsets = (n_short + np.cumsum(extra) - extra).astype(np.int32)
    long_p = rng.uniform(0.0, 0.3, size=int(extra.sum())).astype(np.float32)
    counts = np.concatenate([counts[: len(body)], extra, counts[len(body) :]])
    offsets = np.concatenate([offsets[: len(body)], long_offsets, offsets[len(body) :]])
    return np.concatenate([p[:n_short], long_p, p[n_short:]]), offsets, counts


def kernel_defines(n_samples: int) -> Dict[str, int]:
    """The ``-D`` defines that build mc.cu for ``n_samples`` draws an
    iteration: none at the default ``SAMPLES``."""
    return {} if n_samples == SAMPLES else {"M6A_SAMPLES": n_samples}


def kernel_lib(n_samples: int = SAMPLES) -> _native.Library:
    """csrc/mc.cu built for ``n_samples`` draws an iteration, loaded once
    (``_native.library``)."""
    return _native.library("mc", kernel_defines(n_samples))


def long_sites(counts, long_from: int = MAX_STAGED_READS, n_long: Optional[int] = None):
    """The sites of more than ``long_from`` reads, in site order, as int32:
    the list ``mc_long_site_kernel`` takes.  ``counts`` is a numpy array
    (a numpy list, no device access) or a tensor (a tensor on its device).
    For a tensor, ``n_long`` is the number of such sites where the caller
    knows it (then no host sync; on the card one without it)."""
    if not isinstance(counts, torch.Tensor):
        return np.flatnonzero(np.asarray(counts) > long_from).astype(np.int32)
    if n_long is None:
        n_long = int((counts > long_from).sum())
    # a stable sort of the flags puts the listed sites first, in site order
    return torch.argsort((counts <= long_from).to(torch.int8), stable=True)[:n_long].to(torch.int32)


def long_scratch(n_long: int, n_iters: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mc_long_site_launch``'s scratch for ``n_long`` listed sites: e
    (``n_iters`` floats a site) and a ticket a site, zero.  The kernel
    leaves the tickets zero, so a caller that launches in turn on one
    stream may pass the same scratch again."""
    return (torch.empty(n_long * n_iters, dtype=torch.float32, device=device),
            torch.zeros(n_long, dtype=torch.int32, device=device))


def launch_long_sites(lib: _native.Library, p, offsets, counts, u, site_p, sites, n_iters, n_samples, long_from,
                      scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
    """``lib``'s ``mc_long_site_launch`` over the int32 site list ``sites``
    (on the card), on the current stream, with ``scratch`` (from
    :func:`long_scratch`; a new one by default); raises where the launch
    fails.  Counts no launch."""
    n_long = sites.shape[0]
    e_all, tickets = long_scratch(n_long, n_iters, p.device) if scratch is None else scratch
    _native.launch(lib, "mc_long_site_launch", "ops.launch.mc_long_site", p.device, p.data_ptr(), offsets.data_ptr(),
                   counts.data_ptr(), u.data_ptr(), sites.data_ptr(), e_all.data_ptr(), tickets.data_ptr(),
                   site_p.data_ptr(), counts.shape[0], p.shape[0], int(n_iters), int(n_samples), n_long, long_from)


def site_probability_mc_cuda(
    p: torch.Tensor,  # (N,) f32 packed read probabilities
    offsets: torch.Tensor,  # (S,) i32 first read of each site
    counts: torch.Tensor,  # (S,) i32 reads per site, 0 = padding site
    u: torch.Tensor,  # (n_samples, n_iters) f32 shared draws
    n_iters: int,
    n_samples: int = SAMPLES,
    host_sites: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> torch.Tensor:
    """MC site probabilities (S,), 0 for count-0 sites.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (built for ``n_samples``
    draws an iteration), and the long-site kernel for the sites above
    ``MAX_STAGED_READS`` reads.  Both raise when a
    count exceeds ``MAX_SITE_READS`` or a span leaves ``p``.
    ``host_sites``, the numpy arrays ``offsets`` and ``counts`` were copied
    from, moves that check to the host: no host sync.  On the card a site
    that differs from them so that the launch cannot take it gives NaN (see
    the module docstring)."""
    global launch_count, long_launch_count
    with span("ops.site_probability_mc"):
        n_sites = counts.shape[0]
        device = p.device
        sites = None
        with span("ops.check"):
            if host_sites is not None:
                host_offsets, host_counts = host_sites
                if np.shape(host_offsets) != (n_sites,) or np.shape(host_counts) != (n_sites,):
                    raise ValueError(
                        f"host_sites have shapes {np.shape(host_offsets)} and {np.shape(host_counts)}, "
                        f"expected ({n_sites},) like counts"
                    )
                sites = _check_sites(host_offsets, host_counts, p.shape[0])
            if device.type == "cuda":
                check_tensor("p", p, (torch.float32,), (p.shape[0],), device)
                check_tensor("offsets", offsets, (torch.int32,), (n_sites,), device)
                check_tensor("counts", counts, (torch.int32,), (n_sites,), device)
                check_tensor("u", u, (torch.float32,), (n_samples, n_iters), device)
                if n_iters < 1 or n_samples < 1:
                    raise ValueError(
                        f"the MC kernel takes n_iters >= 1 and n_samples >= 1, got {n_iters}, {n_samples}")
                if sites is None:
                    sites = _check_sites(offsets, counts, p.shape[0])
        if device.type == "cpu":
            return site_probability_mc_plain(p, offsets, counts, u, n_iters, n_samples)
        if device.type != "cuda":
            raise ValueError(f"site_probability_mc_cuda runs on cpu or cuda, got {device}")
        max_count, n_long = sites

        lib = kernel_lib(n_samples)
        site_p = torch.empty(n_sites, dtype=torch.float32, device=device)
        _native.launch(lib, "mc_site_launch", "ops.launch.mc_site", device, p.data_ptr(), offsets.data_ptr(),
                       counts.data_ptr(), u.data_ptr(), site_p.data_ptr(), n_sites, p.shape[0], int(n_iters),
                       int(n_samples), max_count)
        launch_count += 1
        if n_long:
            if host_sites is None:
                listed = long_sites(counts, n_long=n_long)
            else:  # pinned, so the copy makes the host wait for nothing
                listed = torch.from_numpy(long_sites(host_sites[1])).pin_memory().to(device, non_blocking=True)
            launch_long_sites(lib, p, offsets, counts, u, site_p, listed, n_iters, n_samples, MAX_STAGED_READS)
            long_launch_count += 1
        return site_p
