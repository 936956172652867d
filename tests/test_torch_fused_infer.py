"""The port's fused inference step, its two other entry points and the site
ops against the JAX package's.

On the CPU ``fused_inference_t``, ``fused_inference`` and
``fused_read_probability`` run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as tests/test_ops.py runs them.
Tolerances: p 1e-6 (f32 matmuls in another order), site_p 1e-5 (the port
sums 1 - p in f64, the JAX package in f32), mod_ratio equal.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m6anet_tpu.constants import DEFAULT_MIN_READS as JAX_MIN_READS
from m6anet_tpu.constants import PRETRAINED_CONFIGS as JAX_PRETRAINED
from m6anet_tpu.data.batching import pack_sites as jax_pack_sites
from m6anet_tpu.data.dataset import build_dataset as jax_build_dataset
from m6anet_tpu.inference.engine import derive_site_ids as jax_derive_site_ids
from m6anet_tpu.ops import site_ops as jax_site_ops
from m6anet_tpu.ops.encoder_kernel import fused_read_probability as jax_fused_read_probability
from m6anet_tpu.ops.encoder_kernel import prepare_fused_params as jax_prepare_fused_params
from m6anet_tpu.ops.fused_infer_kernel import fused_inference as jax_fused_inference
from m6anet_tpu.ops.fused_infer_kernel import fused_inference_t as jax_fused_inference_t
from m6anet_tpu.ops.fused_infer_kernel import prepare_fused_params_t as jax_prepare_fused_params_t
from m6anet_tpu_torch.constants import DEFAULT_READ_THRESHOLD
from m6anet_tpu_torch.data.batching import pack_sites
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference.engine import derive_site_ids
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.ops import _build, encoder_kernel
from m6anet_tpu_torch.ops import fused_infer_kernel as fik
from m6anet_tpu_torch.ops import site_ops

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def models(production_model):
    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, DEFAULT_MODEL_WEIGHTS

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        port = load_model(tomllib.load(f), DEFAULT_MODEL_WEIGHTS)
    return production_model, port


def _packed_batch(seed=11, n=1024, s=96, lo=5, hi=20):
    """pack_sites layout with padding reads and padding sites (the pattern
    of tests/test_ops.py's fused-kernel tests)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(n, 3)).astype(np.int8)
    site_ids = np.full(n, s, np.int32)
    offsets = np.zeros(s, np.int32)
    counts = np.zeros(s, np.int32)
    cursor = 0
    for i in range(s):
        c = int(rng.integers(lo, hi))
        if cursor + c > n:
            break
        site_ids[cursor : cursor + c] = i
        offsets[i], counts[i] = cursor, c
        cursor += c
    assert cursor < n and (counts == 0).any()  # padding reads and sites
    return X, K, site_ids, offsets, counts


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_fused_inference_matches_jax_kernel(models):
    (jax_model, jax_params), port = models
    X, K, site_ids, offsets, counts = _packed_batch()
    launches = fik.launch_count
    want = jax_fused_inference_t(
        jax_prepare_fused_params_t(jax_params), jnp.asarray(X), jnp.asarray(K.astype(np.int32)),
        jnp.asarray(site_ids), jnp.asarray(counts), DEFAULT_READ_THRESHOLD,
        block_reads=256, interpret=True,
    )
    fp = fik.prepare_fused_params_t(port)
    for sid in (None, torch.from_numpy(site_ids)):  # derived or given site ids
        tX, tK, toff, tcnt = _t(X, K, offsets, counts)
        got = fik.fused_inference_t(fp, tX, tK, sid, toff, tcnt, DEFAULT_READ_THRESHOLD)
        p, site_p, mod_ratio = (t.numpy() for t in got)
        np.testing.assert_allclose(p, np.asarray(want[0]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(site_p, np.asarray(want[1]), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(mod_ratio, np.asarray(want[2]))
    # padding sites: site_p 1, mod_ratio 0, as in the JAX kernel
    pad = counts == 0
    np.testing.assert_array_equal(site_p[pad], 1.0)
    np.testing.assert_array_equal(mod_ratio[pad], 0.0)
    # CPU tensors run the plain version: no kernel launch is counted
    assert fik.launch_count == launches


def test_fused_read_probability_matches_jax_kernel(models):
    """The encoder-only entry point (phase A alone on the card) against the
    JAX package's encoder kernel (tests/test_ops.py:203)."""
    (_, jax_params), port = models
    rng = np.random.default_rng(4)
    X = rng.normal(size=(512, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(512, 3)).astype(np.int32)
    want = np.asarray(jax_fused_read_probability(
        jax_prepare_fused_params(jax_params), jnp.asarray(X), jnp.asarray(K), block_reads=256, interpret=True))
    fp = encoder_kernel.prepare_fused_params(port)
    launches = encoder_kernel.launch_count
    for kmer in (K, K.astype(np.int8)):
        got = encoder_kernel.fused_read_probability(fp, *_t(X, kmer))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with torch.no_grad():
        p_model = port.per_read_probability({"X": torch.from_numpy(X), "kmer": torch.from_numpy(K)})
    torch.testing.assert_close(got, p_model, rtol=0, atol=1e-6)
    assert encoder_kernel.launch_count == launches  # CPU tensors: no launch


def test_site_id_entry_point_matches_jax_kernel(models):
    """The site-id entry point against the JAX package's older fused kernel
    (tests/test_ops.py:219), with padding reads and padding sites."""
    (_, jax_params), port = models
    X, K, site_ids, offsets, counts = _packed_batch(seed=7)
    want = jax_fused_inference(
        jax_prepare_fused_params(jax_params), jnp.asarray(X), jnp.asarray(K.astype(np.int32)),
        jnp.asarray(site_ids), jnp.asarray(counts), DEFAULT_READ_THRESHOLD,
        block_reads=256, interpret=True,
    )
    launches = fik.fused_inference_launch_count
    got = fik.fused_inference(
        fik.prepare_fused_params_t(port), *_t(X, K, site_ids, counts), DEFAULT_READ_THRESHOLD
    )
    p, site_p, mod_ratio = (t.numpy() for t in got)
    np.testing.assert_allclose(p, np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(site_p, np.asarray(want[1]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mod_ratio, np.asarray(want[2]))
    # the same function as fused_inference_t given (offsets, counts)
    want_t = fik.fused_inference_t_plain(
        fik.prepare_fused_params_t(port), *_t(X, K, site_ids, offsets, counts), DEFAULT_READ_THRESHOLD
    )
    for a, b in zip(got, want_t):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fik.fused_inference_launch_count == launches


def test_fused_inference_rejects_site_ids_off_the_dense_layout(models):
    """The kernel reads the spans from the counts, so site ids that break
    pack_sites' dense layout raise (on the card too, see
    tests/test_torch_cuda.py) instead of being summed by the plain version
    alone; a count-0 site among the real ones is still dense."""
    _, port = models
    fp = fik.prepare_fused_params_t(port)
    X, K, site_ids, _, counts = _packed_batch(seed=5)
    counts[4] += counts[3]  # reads of site 3 go to site 4, ids after it unchanged
    counts[3] = 0
    site_ids[site_ids == 3] = 4
    got = fik.fused_inference(fp, *_t(X, K, site_ids, counts), DEFAULT_READ_THRESHOLD)
    assert got[1][3] == 1.0 and got[2][3] == 0.0  # a count-0 site, as padding
    for bad in (site_ids[::-1], np.roll(site_ids, 1), np.where(site_ids == 5, 7, site_ids)):
        with pytest.raises(ValueError, match="dense layout"):
            fik.fused_inference(fp, *_t(X, K, np.ascontiguousarray(bad), counts), DEFAULT_READ_THRESHOLD)
    with pytest.raises(ValueError, match="dense layout"):
        fik.fused_inference(fp, *_t(X, K, site_ids, np.roll(counts, 1)), DEFAULT_READ_THRESHOLD)


def test_site_sums_are_order_free_and_propagate_nan():
    """Site sums are integer sums of fixed-point terms: reordering a site's
    reads changes no bit of its site_p (CUDA's float index_add_ adds in an
    order that changes from run to run), the mean stays within f32 rounding
    of an f64 sum, and a NaN read makes its site NaN and no other."""
    _, _, site_ids, _, counts = _packed_batch(seed=3, lo=1, hi=60)
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 1, size=len(site_ids)).astype(np.float32)
    p[5], p[6] = 1.0, 0.0
    s, n_real = len(counts), int(counts.sum())
    tp, tsid, tcnt = _t(p, site_ids, counts)
    site_p = site_ops.site_probability_exact(tp, tsid, tcnt, s, 20)
    perm = np.concatenate([rng.permutation(n_real), np.arange(n_real, len(p))])
    shuffled = site_ops.site_probability_exact(*_t(p[perm], site_ids[perm]), tcnt, s, 20)
    assert torch.equal(site_p, shuffled)
    mean = site_ops.segment_mean_one_minus_p(tp, tsid, tcnt, s).numpy()
    want = np.zeros(s)
    np.add.at(want, np.minimum(site_ids, s - 1), np.where(site_ids < s, 1.0 - p, 0.0).astype(np.float64))
    np.testing.assert_allclose(mean, (want / np.maximum(counts, 1)).astype(np.float32), rtol=1e-7, atol=0)
    tp[0] = float("nan")
    nan_site = site_ops.site_probability_exact(tp, tsid, tcnt, s, 20)
    assert torch.isnan(nan_site[site_ids[0]]) and not torch.isnan(nan_site[1:]).any()


def test_plain_version_matches_the_model_path(models):
    """fused_inference_t_plain (BN folded) == the modules' forward + site ops."""
    _, port = models
    X, K, site_ids, offsets, counts = _packed_batch(seed=5)
    tX, tK, tsid, toff, tcnt = _t(X, K, site_ids, offsets, counts)
    with torch.no_grad():
        p_ref = port.per_read_probability({"X": tX, "kmer": tK})
    p, site_p, mod_ratio = fik.fused_inference_t_plain(
        fik.prepare_fused_params_t(port), tX, tK, tsid, toff, tcnt, DEFAULT_READ_THRESHOLD
    )
    torch.testing.assert_close(p, p_ref, rtol=0, atol=1e-6)
    s = len(counts)
    torch.testing.assert_close(site_p, site_ops.site_probability_exact(p, tsid, tcnt, s, 20), rtol=0, atol=0)
    torch.testing.assert_close(
        mod_ratio, site_ops.mod_ratio_exact(p, tsid, tcnt, s, DEFAULT_READ_THRESHOLD), rtol=0, atol=0
    )


@pytest.mark.parametrize("n_samples", [20, 1, 7])
def test_site_ops_match_jax(n_samples):
    X, K, site_ids, offsets, counts = _packed_batch(seed=2, lo=1, hi=60)
    rng = np.random.default_rng(n_samples)
    p = rng.uniform(0, 1, size=len(site_ids)).astype(np.float32)
    p[::7] = DEFAULT_READ_THRESHOLD  # reads exactly at the threshold count as hits
    s = len(counts)
    want_site = np.asarray(jax_site_ops.site_probability_exact(
        jnp.asarray(p), jnp.asarray(site_ids), jnp.asarray(counts), s, n_samples))
    want_mr = np.asarray(jax_site_ops.mod_ratio_exact(
        jnp.asarray(p), jnp.asarray(site_ids), jnp.asarray(counts), s, DEFAULT_READ_THRESHOLD))
    tp, tsid, tcnt = _t(p, site_ids, counts)
    got_site = site_ops.site_probability_exact(tp, tsid, tcnt, s, n_samples).numpy()
    got_mr = site_ops.mod_ratio_exact(tp, tsid, tcnt, s, DEFAULT_READ_THRESHOLD).numpy()
    np.testing.assert_allclose(got_site, want_site, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_mr, want_mr)


def test_integer_pow_matches_jax():
    # x >= 0.02 keeps x**20 normal: XLA on the CPU flushes subnormals to zero
    x = np.random.default_rng(0).uniform(0.02, 1, size=4096).astype(np.float32)
    for n in (0, 1, 2, 7, 20):
        want = np.asarray(jax.jit(lambda v: v**n)(jnp.asarray(x)))
        np.testing.assert_array_equal(site_ops.integer_pow(torch.from_numpy(x), n).numpy(), want)


def test_derive_site_ids_matches_jax_and_packer():
    _, thr, norm = JAX_PRETRAINED["HCT116_RNA002"]
    jax_ds = jax_build_dataset(DATA_DIR, min_reads=JAX_MIN_READS, norm_path=norm, mode="Inference")
    ds = build_dataset(DATA_DIR, min_reads=JAX_MIN_READS, norm_path=norm, mode="Inference")
    fn = jax.jit(jax_derive_site_ids, static_argnums=(2, 3))
    n_batches = 0
    for batch, jax_batch in zip(
        pack_sites(ds.iter_sites(), read_capacity=1024, site_capacity=16),
        jax_pack_sites(jax_ds.iter_sites(), read_capacity=1024, site_capacity=16),
    ):
        np.testing.assert_array_equal(batch.site_ids, jax_batch.site_ids)
        got = derive_site_ids(torch.from_numpy(batch.offsets), torch.from_numpy(batch.counts), 1024, 16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(fn(batch.offsets, batch.counts, 1024, 16)))
        np.testing.assert_array_equal(got.numpy(), batch.site_ids)
        n_batches += 1
    assert n_batches > 3  # multiple packings exercised


def _kernel_constants():
    """The ``constexpr int`` constants of csrc/fused_infer.cu, evaluated
    at the released widths (the macros' defaults)."""
    return _build.cu_constants("fused_infer")


def test_packed_weight_layout_matches_the_kernel(models):
    """The weight image prepare_fused_params_t packs sits where the kernel
    reads it: offsets and row strides from the .cu's constants."""
    _, port = models
    c = _kernel_constants()
    fp = fik.prepare_fused_params_t(port)
    w = fp.packed
    wd = fp.widths
    assert c["kWeights"] == fik.f32_layout(wd)["kWeights"] == w.numel()
    assert (c["kH1"], c["kH2"], c["kVocab"], c["kEmb"]) == (wd.hidden1, wd.hidden2, wd.vocab, wd.emb)
    n_in = wd.features + wd.positions * wd.emb
    w1b = w[c["kOffW1B"] : c["kOffW1B"] + wd.hidden1 * c["kW1Stride"]].reshape(wd.hidden1, c["kW1Stride"])
    assert torch.equal(w1b[:, :n_in], fp.w1t) and torch.equal(w1b[:, n_in], fp.b1t[:, 0])
    emb = w[c["kOffEmb"] : c["kOffEmb"] + wd.vocab * c["kEmb"]].reshape(wd.vocab, c["kEmb"])
    assert torch.equal(emb, fp.embt.t())
    w2 = w[c["kOffW2"] : c["kOffW2"] + wd.hidden1 * c["kH2"]].reshape(wd.hidden1, c["kH2"])
    assert torch.equal(w2, fp.w2t.t())  # row k: hidden unit k's fan-out
    assert torch.equal(w[c["kOffB2"] : c["kOffB2"] + wd.hidden2], fp.b2t[:, 0])
    assert torch.equal(w[c["kOffW3"] : c["kOffW3"] + wd.hidden2], fp.w3t[0])
    assert w[c["kOffB3"]] == fp.b3t[0, 0]
    assert not w[c["kOffB3"] + 1 :].any()  # zero padding to a multiple of 4
    assert c["kOffW2"] % 4 == 0 and c["kW1Stride"] % 4 == 0  # float4 rows


def test_ragged_tail_batches_end_the_tile_raggedly(models):
    """The tail cases the card checks run on: read counts around the .cu's
    tile, pack_sites-shaped with padding reads and sites, and through the
    plain version equal to the model path."""
    _, port = models
    c = _kernel_constants()
    tile = c["kReadThreads"] * c["kReadTile"]
    batches = fik.ragged_tail_batches(tile)
    assert [b[0].shape[0] for b in batches] == sorted({1, 2, 3, 255, 257, tile - 1, tile + 1, 4097})
    fp = fik.prepare_fused_params_t(port)
    for X, K, offsets, counts in batches:
        n = X.shape[0]
        assert counts.sum() == n - n // 8 and list(counts[-2:]) == [0, 0]
        assert (offsets[:-2] == np.cumsum(counts[:-2]) - counts[:-2]).all()
        p, site_p, _ = fik.fused_inference_t(fp, *_t(X, K), None, *_t(offsets, counts), DEFAULT_READ_THRESHOLD)
        with torch.no_grad():
            p_ref = port.per_read_probability({"X": torch.from_numpy(X), "kmer": torch.from_numpy(K)})
        torch.testing.assert_close(p, p_ref, rtol=0, atol=1e-6)
        assert (site_p[-2:] == 1.0).all()  # padding sites


@pytest.mark.parametrize("bad_id", [-1, 66])
def test_out_of_range_kmer_ids_raise(models, bad_id):
    """Both the wrapper and the plain version refuse an id outside [0, 66)
    (the kernel reads the embedding table with it unchecked)."""
    _, port = models
    fp = fik.prepare_fused_params_t(port)
    X, K, _, offsets, counts = _packed_batch()
    K = K.astype(np.int32)
    K[17, 1] = bad_id
    args = (*_t(X, K), None, *_t(offsets, counts), DEFAULT_READ_THRESHOLD)
    for fn in (fik.fused_inference_t, fik.fused_inference_t_plain):
        with pytest.raises(ValueError, match="kmer_ids"):
            fn(fp, *args)


def test_wrapper_rejects_other_devices(models):
    _, port = models
    fp = fik.prepare_fused_params_t(port)
    X, K, _, offsets, counts = _packed_batch()
    meta = [torch.from_numpy(a).to("meta") for a in (X, K, offsets, counts)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fik.fused_inference_t(fp, meta[0], meta[1], None, meta[2], meta[3], DEFAULT_READ_THRESHOLD)
