"""The MC site probability at the shapes past mc.cu's first envelope: sites
longer than the kernel stages in shared memory (``MAX_STAGED_READS``), up to
the draw index's range (``MAX_SITE_READS``), and any draws per iteration.

On the CPU ``site_probability_mc_cuda`` runs its plain version, held here
against the JAX package's Pallas kernel in interpret mode over the same
draws, at PERF.md section 2's 2e-4 (the Pallas kernel's bf16 split); the
CUDA kernels are held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py`` phase 22.
"""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m6anet_tpu.ops.mc_kernel import site_probability_mc_pallas
from m6anet_tpu_torch.ops import _build, mc_kernel, random

PALLAS_ATOL = 2e-4


def _long_site_batch(seed=0):
    """A 70,000-read site (above the staged cap) between short ones, a
    count-0 site and padding reads."""
    rng = np.random.default_rng(seed)
    counts = np.array([5, 70_000, 300, 0, 1], np.int32)
    offsets = np.array([0, 5, 70_005, 0, 70_305], np.int32)
    p = rng.uniform(0.0, 0.3, size=70_400).astype(np.float32)
    return p, offsets, counts


@pytest.mark.parametrize("n_samples", [1, 20, 32])
def test_plain_mc_matches_the_jax_pallas_kernel_at_a_long_site(n_samples):
    """A 70,000-read site and n_samples 1, 20 and 32: the plain version
    over shared_draws' U against site_probability_mc_pallas (interpret
    mode) over the same key, whose read_cap the engine grows to the longest
    site."""
    p, offsets, counts = _long_site_batch()
    assert counts.max() > mc_kernel.MAX_STAGED_READS
    n_iters = 64
    key = jnp.asarray(np.array([0, 7], np.uint32))
    want = np.asarray(site_probability_mc_pallas(
        jnp.asarray(p), jnp.asarray(offsets), jnp.asarray(counts), key, n_iters=n_iters, n_samples=n_samples,
        read_cap=-(-int(counts.max()) // 128) * 128, interpret=True))
    u = torch.from_numpy(random.shared_draws(7, n_iters, n_samples))
    launches = mc_kernel.launch_count, mc_kernel.long_launch_count
    got = mc_kernel.site_probability_mc_cuda(*map(torch.from_numpy, (p, offsets, counts)), u, n_iters, n_samples,
                                             host_sites=(offsets, counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PALLAS_ATOL)
    assert got[3] == 0 and (got[counts > 0] > 0).all()
    assert (mc_kernel.launch_count, mc_kernel.long_launch_count) == launches  # CPU tensors: no launch


def test_ragged_batch_with_long_sites_keeps_every_other_site():
    """ragged_mc_batch(long_sites=True) adds LONG_SITE_COUNTS' sites (one
    read above the staged cap, 100,000 and 1,000,000 reads) before the
    padding sites, their reads after the others': every other site keeps
    its offset and reads, and its plain value."""
    p0, off0, cnt0 = mc_kernel.ragged_mc_batch()
    p, offsets, counts = mc_kernel.ragged_mc_batch(long_sites=True)
    n = len(cnt0) - 16
    long_idx = np.arange(n, n + 3)
    assert list(counts[long_idx]) == list(mc_kernel.LONG_SITE_COUNTS) and counts[long_idx][0] == 57_345
    assert (counts[:n] == cnt0[:n]).all() and (offsets[:n] == off0[:n]).all() and not counts[-16:].any()
    short = int(cnt0.sum())
    assert (p[:short] == p0[:short]).all() and (offsets[long_idx] >= short).all()
    assert offsets[long_idx][-1] + counts[long_idx][-1] + 100 == len(p)
    u = torch.from_numpy(random.shared_draws(4, 3))
    got = mc_kernel.site_probability_mc_plain(*map(torch.from_numpy, (p, offsets, counts)), u, 3)
    alone = mc_kernel.site_probability_mc_plain(*map(torch.from_numpy, (p0, off0, cnt0)), u, 3)
    keep = torch.from_numpy(np.concatenate([np.arange(n), np.arange(len(counts) - 16, len(counts))]))
    torch.testing.assert_close(got[keep], alone, rtol=0, atol=1e-7)
    assert bool(torch.isfinite(got).all()) and bool((got[torch.from_numpy(long_idx)] > 0).all())


def test_sites_are_checked_up_to_the_draw_index_range():
    """The wrapper takes every count up to MAX_SITE_READS (2^23 - 1) on
    either route of the check, reports the staged sites' largest count and
    the longer sites' number, and raises above it, naming the limit."""
    counts = np.array([3, 1000, mc_kernel.MAX_STAGED_READS, mc_kernel.MAX_STAGED_READS + 1, 0], np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    n = int(counts.sum())
    for sites in ((offsets, counts), tuple(map(torch.from_numpy, (offsets, counts)))):
        assert mc_kernel._check_sites(*sites, n) == (mc_kernel.MAX_STAGED_READS, 1)
    big = np.array([3, mc_kernel.MAX_SITE_READS + 1], np.int32)
    for sites in ((np.zeros(2, np.int32), big), (torch.zeros(2, dtype=torch.int32), torch.from_numpy(big))):
        with pytest.raises(ValueError, match=f"{mc_kernel.MAX_SITE_READS + 1} reads, above the .*2\\^23"):
            mc_kernel._check_sites(*sites, 1 << 24)


def test_each_draw_count_builds_its_own_kernel():
    """mc.cu's draws per iteration come from M6A_SAMPLES, 20 by default:
    kernel_defines passes any other count, and the source holds it."""
    assert mc_kernel.kernel_defines(mc_kernel.SAMPLES) == {}
    for n_samples in (1, 32, 100):
        defines = mc_kernel.kernel_defines(n_samples)
        assert defines == {"M6A_SAMPLES": n_samples}
        assert _build.cu_constants("mc", defines)["kSamples"] == n_samples
    assert _build.cu_constants("mc")["kSamples"] == mc_kernel.SAMPLES == 20


def test_mc_long_launch_argtypes_match_the_kernel_source():
    """mc_kernel.LONG_LAUNCH_ARGTYPES against mc_long_site_launch's
    parameters in mc.cu."""
    with open(os.path.join(os.path.dirname(mc_kernel.__file__), "csrc", "mc.cu")) as f:
        params = re.search(r"int mc_long_site_launch\(([^)]*)\)", f.read()).group(1).split(",")
    scalars = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}
    want = [ctypes.c_void_p if "*" in param else scalars[param.split()[0]] for param in params]
    assert mc_kernel.LONG_LAUNCH_ARGTYPES == want
    assert [param.split()[-1] for param in params][-3:] == ["long_from", "grid", "stream_ptr"]
