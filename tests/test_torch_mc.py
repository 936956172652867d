"""The port's MC site method against the JAX package's.

Three pieces: the shared draws ``U`` (``ops/random.py``, a numpy replay of
JAX's threefry), the ``torch`` backend's ``site_ops.site_probability_mc``
(the counterpart of the JAX ``xla`` backend's) and the CUDA kernel's
function ``mc_kernel.site_probability_mc_cuda``, which on CPU tensors runs
its plain version (the counterpart of ``site_probability_mc_pallas``, run
here in Pallas interpret mode as tests/test_ops.py runs it).

Tolerances: ``U`` bit for bit; the torch backend 1e-5 (f32 sums in another
order); the kernel's plain version 1e-6 against the numpy oracle of
tests/test_ops.py (the same arithmetic, the sum over iterations in another
precision) and 2e-4 against the Pallas kernel (its bf16 hi/lo split, the
bound tests/test_ops.py holds it to)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m6anet_tpu.ops import site_ops as jax_site_ops
from m6anet_tpu.ops.mc_kernel import site_probability_mc_pallas
from m6anet_tpu_torch.ops import mc_kernel, random, site_ops

SEEDS = [0, 7, 2**33 + 5]


def _jax_key(seed):
    """The JAX engine's raw key for a seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    return jnp.asarray(np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32))


@pytest.mark.parametrize("n_iters", [64, 1000])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax_bit_for_bit(seed, n_iters):
    key = random.key_from_seed(seed)
    np.testing.assert_array_equal(key, np.asarray(_jax_key(seed)))
    if seed < 2**32:
        np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    for ci in (0, 1, 3):
        want = np.asarray(jax.random.uniform(jax.random.fold_in(_jax_key(seed), ci), (20, n_iters)))
        got = random.uniform(random.fold_in(key, ci), (20, n_iters))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_shared_draws_are_the_pallas_kernels_chunks():
    """U for 1500 iterations: a 1024-column chunk from fold_in(key, 0), then
    476 columns from fold_in(key, 1) (mc_kernel.py:305-319)."""
    key = _jax_key(3)
    want = np.concatenate([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (20, 1024))),
        np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (20, 476))),
    ], axis=1)
    got = random.shared_draws(3, 1500)
    assert got.shape == (20, 1500) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(random.shared_draws(3, 300), np.asarray(
        jax.random.uniform(jax.random.fold_in(key, 0), (20, 300))))


def _layout(rng, n_sites, site_cap, counts=None, lo=1, hi=60, p_hi=0.3, pad_reads=37):
    """pack_sites layout: sites back to back, then padding sites (count 0,
    offset 0) and padding reads.  p below 0.3 keeps the values away from 1,
    so the tolerances bite (see tests/test_ops.py:123-126)."""
    if counts is None:
        counts = rng.integers(lo, hi, size=n_sites)
    all_counts = np.zeros(site_cap, np.int32)
    offsets = np.zeros(site_cap, np.int32)
    cursor = 0
    for i, c in enumerate(counts):
        all_counts[i] = c
        offsets[i] = cursor if c > 0 else 0
        cursor += int(c)
    p = rng.uniform(0.0, p_hi, size=cursor + pad_reads).astype(np.float32)
    return p, offsets, all_counts


@pytest.mark.parametrize(
    "site_cap, n_iters", [(8, 200), (8, 4000), (1024, 200), (1024, 4000), (16384, 100)]
)
def test_site_probability_mc_matches_jax(site_cap, n_iters):
    rng = np.random.default_rng(site_cap + n_iters)
    p, offsets, counts = _layout(rng, min(site_cap - 2, 200), site_cap)
    key = random.key_from_seed(11)
    want = np.asarray(jax_site_ops.site_probability_mc(
        jnp.asarray(p), jnp.asarray(offsets), jnp.asarray(counts), jnp.asarray(key), n_iters=n_iters))
    got = site_ops.site_probability_mc(*map(torch.from_numpy, (p, offsets, counts)), key, n_iters=n_iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got.numpy()[counts == 0] == 0).all()
    assert 0.05 < got.numpy()[counts > 0].mean() < 0.999  # not saturated


def test_mc_chunk_size_formula():
    """The chunks decide the draws, so the formula is the JAX package's
    (site_ops.py:103): 64 iterations, fewer above ~9,800 sites."""
    assert site_ops.mc_chunk_size(1000, 1024) == 64
    assert site_ops.mc_chunk_size(1000, 16384) == 38
    assert site_ops.mc_chunk_size(20, 8) == 20
    assert site_ops.mc_chunk_size(1000, 10**9) == 1


def _oracle(p, offsets, counts, u):
    """tests/test_ops.py:130-144's replay, with the draw index taken from the
    f32 product U * c as both kernels take it (numpy would promote
    float32 * int32 to float64)."""
    out = np.zeros(len(counts), np.float32)
    for s, c in enumerate(counts):
        c = int(c)
        if c == 0:
            continue
        idx = np.minimum((u * np.float32(c)).astype(np.int32), c - 1)
        with np.errstate(divide="ignore"):  # log1p(-1) = -inf, then clamped
            l = np.maximum(np.log1p(-p[offsets[s] : offsets[s] + c]), -1e4)
        out[s] = 1.0 - np.mean(np.exp(l[idx].sum(axis=0)).astype(np.float64))
    return out


@pytest.mark.parametrize("n_iters", [300, 1500])
def test_mc_kernel_plain_matches_oracle_and_pallas(n_iters):
    rng = np.random.default_rng(9)
    counts = rng.integers(150, 500, size=12)
    counts[3], counts[4], counts[5], counts[6], counts[7] = 128, 129, 0, 1, 512
    p, offsets, counts = _layout(rng, 12, 16, counts=counts)
    u = random.shared_draws(7, n_iters)
    got = mc_kernel.site_probability_mc_cuda(*map(torch.from_numpy, (p, offsets, counts, u)), n_iters).numpy()
    want = _oracle(p, offsets, counts, u)
    assert 0.05 < want[counts > 1].min() and want.max() < 0.999
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pallas = np.asarray(site_probability_mc_pallas(
        jnp.asarray(p), jnp.asarray(offsets), jnp.asarray(counts), _jax_key(7),
        n_iters=n_iters, read_cap=512, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-4)
    assert (got[counts == 0] == 0).all()


def test_mc_kernel_plain_clamps_p_of_one():
    """p == 1 gives log1p(-1) = -inf, clamped to -1e4: every draw of that
    read zeroes its iteration's product, and nothing turns NaN."""
    p = np.array([1.0, 0.2, 0.1, 1.0], np.float32)
    offsets = np.array([0, 0, 3, 0], np.int32)
    counts = np.array([3, 0, 1, 0], np.int32)
    u = random.shared_draws(0, 500)
    got = mc_kernel.site_probability_mc_cuda(*map(torch.from_numpy, (p, offsets, counts, u)), 500).numpy()
    np.testing.assert_allclose(got, _oracle(p, offsets, counts, u), rtol=0, atol=1e-6)
    assert got[2] == 1.0 and 0.99 < got[0] <= 1.0 and got[1] == got[3] == 0.0


def _rotate(p, offsets, counts, n_sites):
    """Move site 0's reads to the end of the real reads (test_ops.py:179)."""
    n0, cursor = int(counts[0]), int(counts.sum())
    p_rot = np.concatenate([p[n0:cursor], p[:n0], p[cursor:]])
    offsets_rot = np.concatenate([offsets[1:n_sites] - n0, [cursor - n0], offsets[n_sites:]]).astype(np.int32)
    counts_rot = np.concatenate([counts[1:n_sites], [n0], counts[n_sites:]]).astype(np.int32)
    return p_rot, offsets_rot, counts_rot


@pytest.mark.parametrize("fn", ["torch_backend", "kernel"])
def test_mc_is_placement_invariant(fn):
    """A site's value depends only on (seed, its reads): moving it to
    another slot of the batch changes no bit (host-shard merging relies on
    this)."""
    rng = np.random.default_rng(6)
    n_sites = 6
    p, offsets, counts = _layout(rng, n_sites, 8, lo=20, hi=120)

    def run(p, offsets, counts):
        args = map(torch.from_numpy, (p, offsets, counts))
        if fn == "torch_backend":
            return site_ops.site_probability_mc(*args, random.key_from_seed(1), n_iters=200).numpy()
        u = torch.from_numpy(random.shared_draws(1, 200))
        return mc_kernel.site_probability_mc_cuda(*args, u, 200).numpy()

    a = run(p, offsets, counts)
    b = run(*_rotate(p, offsets, counts, n_sites))
    np.testing.assert_array_equal(a[0], b[n_sites - 1])
    np.testing.assert_array_equal(a[1:n_sites], b[: n_sites - 1])


def test_count_zero_gives_zero_and_oversized_sites_raise():
    rng = np.random.default_rng(3)
    p, offsets, counts = _layout(rng, 5, 8, counts=np.array([40, 1, 0, 300, 2]))
    t = [torch.from_numpy(a) for a in (p, offsets, counts)]
    u = torch.from_numpy(random.shared_draws(0, 100))
    got = mc_kernel.site_probability_mc_cuda(*t, u, 100).numpy()
    assert (got[counts == 0] == 0).all() and (got[counts > 0] > 0).all()
    torch_backend = site_ops.site_probability_mc(*t, random.key_from_seed(0), n_iters=100).numpy()
    assert (torch_backend[counts == 0] == 0).all()
    # a site above the shared memory the kernel sizes per launch raises on
    # either device, naming the backend that has no such limit
    cap = mc_kernel.MAX_SITE_READS
    p, offsets, counts = _layout(rng, 2, 4, counts=np.array([3, cap + 1]))
    big = [torch.from_numpy(a) for a in (p, offsets, counts)]
    u = torch.from_numpy(random.shared_draws(0, 4))
    for fn in (mc_kernel.site_probability_mc_cuda, mc_kernel.site_probability_mc_plain):
        with pytest.raises(ValueError, match=f"{cap + 1} reads, above the {cap}.*--backend torch"):
            fn(*big, u, 4)
    big[2][1] = cap  # the largest site the kernel holds
    assert bool(torch.isfinite(mc_kernel.site_probability_mc_cuda(*big, u, 4)).all())
    with pytest.raises(ValueError, match="shape"):
        mc_kernel.site_probability_mc_plain(*t, u[:, :50], 100)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="cpu or cuda"):
        mc_kernel.site_probability_mc_cuda(*meta, u.to("meta"), 100)
