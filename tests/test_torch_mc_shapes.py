"""The MC site probability at the shapes past mc.cu's first envelope: sites
longer than the kernel stages in shared memory (``MAX_STAGED_READS``), up to
the draw index's range (``MAX_SITE_READS``), and any draws per iteration.

On the CPU ``site_probability_mc_cuda`` runs its plain version, held here
against the JAX package's Pallas kernel in interpret mode over the same
draws, at PERF.md section 2's 2e-4 (the Pallas kernel's bf16 split); the
CUDA kernels are held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py`` phase 22.
"""
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


def test_long_site_lists_from_the_host_and_the_tensors_agree():
    """long_sites from host_sites' numpy counts and from the tensors: the
    sites above MAX_STAGED_READS in site order as int32, none for a batch
    without them, and every site of a read or more for long_from 0 (the
    list that sends every site through the long-site kernel); from the
    tensors with the count known as without it."""
    _, _, counts = mc_kernel.ragged_mc_batch(long_sites=True)
    _, _, short = mc_kernel.ragged_mc_batch()
    n = len(short) - 16
    cases = [(counts, mc_kernel.MAX_STAGED_READS, np.arange(n, n + 3)),
             (short, mc_kernel.MAX_STAGED_READS, np.arange(0)),
             (counts, 0, np.flatnonzero(counts >= 1)),
             (np.zeros(0, np.int32), 0, np.arange(0))]
    for c, long_from, want in cases:
        host = mc_kernel.long_sites(c, long_from)
        device = mc_kernel.long_sites(torch.from_numpy(c), long_from)
        known = mc_kernel.long_sites(torch.from_numpy(c), long_from, n_long=len(want))  # the wrapper's: no sync
        assert host.dtype == np.int32 and device.dtype == known.dtype == torch.int32
        assert host.tolist() == device.tolist() == known.tolist() == want.tolist()
    assert (counts[mc_kernel.long_sites(counts)] > mc_kernel.MAX_STAGED_READS).all()
    assert mc_kernel.long_sites(counts).tolist() == mc_kernel.long_sites(counts, mc_kernel.MAX_STAGED_READS).tolist()


def test_long_kernel_constants_and_blocks_cover_the_iterations(tmp_path):
    """mc.cu's long-kernel tunings parse through _build.cu_constants, at
    every draw count: a block is whole warps, each of the kThreads f64
    chains belongs to one thread of a site's last block, and a block takes
    kLongSlice iterations.  long_blocks_per_site, compiled for the host
    with g++ from the source's constants, gives each site the fewest
    blocks whose slices cover T at T = 1, 256, 257, 1000 and 4097."""
    import subprocess

    for defines in ({}, mc_kernel.kernel_defines(1), mc_kernel.kernel_defines(32)):
        c = _build.cu_constants("mc", defines)
        assert c["kLongThreads"] % 32 == 0 and c["kThreads"] % c["kLongThreads"] == 0
        assert c["kLongChains"] * c["kLongThreads"] == c["kThreads"] == 256
        assert c["kLongSlice"] == c["kLongThreads"] * c["kLongIters"] and c["kLongLoads"] >= 1
    with open(os.path.join(_build.CSRC_DIR, "mc.cu")) as f:
        text = f.read()
    body = text[text.index("namespace {") + len("namespace {") :]
    body = body[: re.search(r"^(__global__|__device__)", body, re.M).start()]
    iters = (1, 256, 257, 1000, 4097)
    src, exe = tmp_path / "blocks.cpp", tmp_path / "blocks"
    src.write_text("#include <cstdint>\n#include <cstdio>\nnamespace mc {\n" + body + "}\nint main() {\n"
                   + "".join(f'  std::printf("%lld\\n", (long long)mc::long_blocks_per_site({t}));\n' for t in iters)
                   + '  std::printf("%d\\n", mc::kLongSlice);\n}\n')
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", str(exe), str(src)], check=True, capture_output=True)
    *blocks, slice_ = map(int, subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.split())
    assert slice_ == _build.cu_constants("mc")["kLongSlice"]
    for n_iters, n in zip(iters, blocks):
        assert n * slice_ >= n_iters > (n - 1) * slice_, (n_iters, n, slice_)


@pytest.mark.parametrize("n_samples", [1, 20, 32, 33, 128])
def test_long_kernel_draw_rounds_cover_n_samples(n_samples):
    """mc.cu's long kernel issues an iteration's draws in kLongRounds rounds
    of kLongDraws: one round up to kLongRound (32) draws, so the builds the
    sweep times keep their code; past it the fewest rounds of at most
    kLongRound that cover n_samples, the last one short by less than a
    round."""
    c = _build.cu_constants("mc", mc_kernel.kernel_defines(n_samples))
    rounds, draws = c["kLongRounds"], c["kLongDraws"]
    assert c["kSamples"] == n_samples and draws <= c["kLongRound"] == 32
    assert rounds == -(-n_samples // 32) and rounds * draws >= n_samples > (rounds - 1) * draws
    assert (rounds == 1) == (n_samples <= 32)


def test_long_site_sectors_count_each_touched_sector_once():
    """_sweep.long_site_sectors, the bytes of p in the long kernel's bound:
    for the sites past long_from alone, the distinct 32-byte sectors that
    offset + min(trunc(U * c), c - 1) touches, against a set built draw by
    draw, fewer than a sector a draw."""
    from m6anet_tpu_torch.scripts import _sweep

    rng = np.random.default_rng(4)
    counts = np.array([3, 70, 0, 1000, 9, 50], np.int32)
    offsets = (np.cumsum(counts) - counts + 5).astype(np.int32)
    u = rng.uniform(size=(4, 37)).astype(np.float32)
    u[0, 0] = np.float32(1.0) - np.float32(2.0**-24)  # rounds up to c at some counts: clamped to c - 1
    want = 0
    for o, c in zip(offsets, counts):
        if c > 8:
            want += len({(int(o) + min(int(np.float32(x) * np.float32(c)), int(c) - 1)) // 8 for x in u.ravel()})
    got = _sweep.long_site_sectors(offsets, counts, u, long_from=8)
    # four sites past 8 reads: at most a sector a draw, and at the site of
    # 9 reads (two or three sectors) fewer
    assert got == want and 0 < got < 4 * u.size
    assert _sweep.long_site_sectors(offsets, counts, u) == 0  # none past MAX_STAGED_READS
