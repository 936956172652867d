"""Monte-Carlo site probabilities with draws shared by all sites.

The port of ``site_probability_mc_pallas`` in the JAX package's
``ops/mc_kernel.py``: per site with ``c >= 1`` reads,

    site_p = 1 - (1 / n_iters) * sum_t exp(sum_j max(log1p(-p[off + min(floor(U[j, t] * c), c - 1)]), -1e4))

with ``U`` (n_samples, n_iters) from ``random.shared_draws`` (iteration
chunks of ``min(n_iters, 1024)`` columns, chunk ``ci`` drawn from
``fold_in(key, ci)``), the same for every site and every batch, so a site's
value depends only on (seed, its reads) and not on its place in a batch.
Count-0 sites give 0.  A site may hold at most ``MAX_SITE_READS`` reads
on either device: the kernel stages a site's values in shared memory, sized
at each launch to the batch's largest count.

On a CUDA tensor :func:`site_probability_mc_cuda` launches the hand-written
Hopper kernel in ``csrc/mc.cu`` and counts the launch in ``launch_count``;
on a CPU tensor it runs :func:`site_probability_mc_plain`, the same function
in plain PyTorch.  There is no fallback from one to the other.  The kernel
file's header states its bound on the card and its design.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .fused_infer_kernel import check_tensor

# launches of the CUDA kernel in this process
launch_count = 0

# reads of one site: 224 KB of f32 values, within the 227 KB of shared
# memory one block may opt into on sm_90
MAX_SITE_READS = 56 * 1024
# elements of the plain version's (n_samples, n_iters, sites) gather per site chunk
_PLAIN_CHUNK = 1 << 24


def _check_sites(offsets: torch.Tensor, counts: torch.Tensor, n_reads: int) -> int:
    """Raise on a count above ``MAX_SITE_READS`` or a span outside ``p``;
    return the largest count (one host sync on the card)."""
    if not counts.numel():
        return 0
    real = counts > 0
    outside = real & ((offsets < 0) | (offsets.long() + counts.long() > n_reads))
    biggest, n_outside = torch.stack([counts.max().long(), outside.sum()]).tolist()
    if biggest > MAX_SITE_READS:
        raise ValueError(
            f"a site has {biggest} reads, above the {MAX_SITE_READS} the MC "
            "kernel holds in shared memory; rerun dataprep with a lower "
            "--readcount_max, or use --backend torch"
        )
    if n_outside:
        raise ValueError(f"{n_outside} site spans (offsets, counts) reach outside p")
    return biggest


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


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ._build import cuda_library

            lib = ctypes.CDLL(cuda_library("mc"))
            lib.mc_site_launch.restype = ctypes.c_int
            lib.mc_site_launch.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.mc_error_string.restype = ctypes.c_char_p
            lib.mc_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def site_probability_mc_cuda(
    p: torch.Tensor,  # (N,) f32 packed read probabilities
    offsets: torch.Tensor,  # (S,) i32 first read of each site
    counts: torch.Tensor,  # (S,) i32 reads per site, 0 = padding site
    u: torch.Tensor,  # (n_samples, n_iters) f32 shared draws
    n_iters: int,
    n_samples: int = 20,
) -> torch.Tensor:
    """MC site probabilities (S,), 0 for count-0 sites.  CPU tensors run the
    plain version; CUDA tensors launch the kernel.  Both raise when a count
    exceeds ``MAX_SITE_READS``."""
    global launch_count
    if p.device.type == "cpu":
        return site_probability_mc_plain(p, offsets, counts, u, n_iters, n_samples)
    if p.device.type != "cuda":
        raise ValueError(f"site_probability_mc_cuda runs on cpu or cuda, got {p.device}")
    device = p.device
    n_sites = counts.shape[0]
    check_tensor("p", p, (torch.float32,), (p.shape[0],), device)
    check_tensor("offsets", offsets, (torch.int32,), (n_sites,), device)
    check_tensor("counts", counts, (torch.int32,), (n_sites,), device)
    check_tensor("u", u, (torch.float32,), (n_samples, n_iters), device)
    if n_iters < 1 or n_samples < 0:
        raise ValueError(f"need n_iters >= 1 and n_samples >= 0, got {n_iters}, {n_samples}")
    max_count = _check_sites(offsets, counts, p.shape[0])

    lib = _kernel_lib()
    site_p = torch.empty(n_sites, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mc_site_launch(
            p.data_ptr(), offsets.data_ptr(), counts.data_ptr(), u.data_ptr(), site_p.data_ptr(),
            n_sites, int(n_iters), int(n_samples), max_count, stream,
        )
    if err != 0:
        raise RuntimeError(f"mc kernel launch failed: {lib.mc_error_string(err).decode()}")
    launch_count += 1
    return site_p
