"""Phase B of the port's fused step (``site_reduce_kernel`` in
``m6anet_tpu_torch/ops/csrc/fused_infer.cu``) and the wrappers' host check
of the k-mer ids, on the CPU.

The kernel sums each site's ``1 - p`` as whole numbers of 2^-24 units:
``one_minus_units`` holds that claim over sampled f32 p, and
``kernel_model`` replays the kernel's arithmetic in numpy (a lane's 16-byte
chunks of the span from the 16-byte boundary below it, 32-bit round sums,
64-bit lane totals split at bit 24 into two 32-bit sums over the site's
lanes, the hit count, the flag of a read outside [0, 1]), which must give
the plain site ops' bits.
The kernel itself is held to the plain site ops, bit for bit, by
tests/test_torch_cuda.py and chip_smoke.py on the card.  Against the JAX
package's ``fused_inference_t`` (Pallas interpret mode, as its own tests
run it) the port holds PERF.md's tolerances: p 1e-6, site_p 1e-5,
mod_ratio equal but at reads within 1e-6 of the threshold."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m6anet_tpu.ops.fused_infer_kernel import fused_inference_t as jax_fused_inference_t
from m6anet_tpu.ops.fused_infer_kernel import prepare_fused_params_t as jax_prepare_fused_params_t
from m6anet_tpu_torch.constants import DEFAULT_READ_THRESHOLD
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.ops import encoder_kernel, mc_kernel, site_ops
from m6anet_tpu_torch.ops import fused_infer_kernel as fik
from m6anet_tpu_torch.scripts import _sweep

UNIT = 2.0**24
EDGES = [0.0, 2.0**-149, 2.0**-25, 0.5 - 2.0**-25, 0.5, 1 - 2.0**-24, 1.0]


@pytest.fixture(scope="module")
def models(production_model):
    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, DEFAULT_MODEL_WEIGHTS

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        port = load_model(tomllib.load(f), DEFAULT_MODEL_WEIGHTS)
    return production_model, port


def one_minus_units(p: np.ndarray) -> np.ndarray:
    """(1 - p) in f32, times 2^24, as the kernel's one_minus_units takes it."""
    return (np.float32(1.0) - p.astype(np.float32)).astype(np.float64) * UNIT


def test_one_minus_p_is_a_whole_number_of_units():
    """For every f32 p in [0, 1] (sampled over its bit patterns, and the
    edges), 1 - p rounded to f32 is a whole number of 2^-24 units, at most
    2^24: so the kernel's integer sums are exact in any order."""
    bits = np.random.default_rng(0).integers(0, 0x3F800001, size=1 << 22, dtype=np.uint32)
    p = np.concatenate([bits.view(np.float32), np.array(EDGES, np.float32), fik.PHASE_B_EDGES])
    assert ((p >= 0) & (p <= 1)).all()
    units = one_minus_units(p)
    assert (units == np.floor(units)).all() and units.min() >= 0 and units.max() <= UNIT
    assert units[-len(EDGES):].tolist() == [UNIT, UNIT, UNIT, 2.0**23, 2.0**23, 1.0, 0.0]  # ties to even


def _kernel_shape():
    """(kSiteLanes, kChunkLoads) of csrc/fused_infer.cu."""
    import re

    with open(os.path.join(os.path.dirname(fik.__file__), "csrc", "fused_infer.cu")) as f:
        text = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
                 for name in ("kSiteLanes", "kChunkLoads"))


def kernel_model(p: np.ndarray, offsets: np.ndarray, counts: np.ndarray, threshold: float, n_samples: int):
    """(site_p, mod_ratio) as site_reduce_kernel computes them, in numpy: a
    site's span, from the 16-byte boundary at or below its first read (p
    starts on one), is 16-byte chunks; lane t of the site's kSiteLanes
    takes chunks t, t + kSiteLanes, ..., kChunkLoads of them a round (a
    round's sum a 32-bit number), adds its rounds in 64 bits, and the
    site's lanes add their totals' bits 24 and up and below 24 as two
    32-bit sums."""
    lanes, loads = _kernel_shape()
    site_p = np.empty(len(counts), np.float32)
    mod_ratio = np.empty(len(counts), np.float32)
    for s, (b, n) in enumerate(zip(offsets.tolist(), counts.tolist())):
        if n < 0 or b < 0 or b + n > len(p):
            site_p[s] = mod_ratio[s] = np.nan
            continue
        idx = np.arange(b, b + n)
        values = p[idx]
        chunk = (idx - (b - b % 4)) // 4
        bad = bool((~((values >= 0) & (values <= 1))).any())
        terms = one_minus_units(np.where(bad, 0.5, values)).astype(np.uint64)
        lane, rnd = chunk % lanes, chunk // lanes // loads
        round_sums = np.zeros((lanes, int(rnd.max(initial=0)) + 1), np.uint64)
        np.add.at(round_sums, (lane, rnd), terms)
        assert (round_sums < 2**32).all()  # a lane's round fits its 32 bits
        per_lane = round_sums.sum(axis=1)
        hi, lo = int((per_lane >> np.uint64(24)).sum()), int((per_lane & np.uint64(0xFFFFFF)).sum())
        assert hi < 2**32 and lo < 2**32  # each sum over the site's lanes fits its 32 bits
        units = (hi << 24) + lo
        assert units == int(terms.sum())
        hits = int((values >= np.float32(threshold)).sum())
        cnt = max(n, 1)
        mean = np.float32(np.nan) if bad else np.float32(units * 2.0**-24 / cnt)
        site_p[s] = 1 - site_ops.integer_pow(torch.tensor([mean]), n_samples).numpy()[0]
        mod_ratio[s] = np.float32(hits) / np.float32(cnt)
    return site_p, mod_ratio


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    return bool((nan_a == nan_b).all() and (a[~nan_a].view(np.int32) == b[~nan_b].view(np.int32)).all())


def _site_ids(counts: np.ndarray, n: int) -> np.ndarray:
    ids = np.full(n, len(counts), np.int32)
    ids[: counts.sum()] = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    return ids


@pytest.mark.parametrize("n_samples", [20, 1, 0])
def test_kernel_model_gives_the_site_ops_bits(n_samples):
    """The model of the kernel's sums equals site_ops.site_probability_exact
    and mod_ratio_exact bit for bit on site_reduce_batch (counts 0, 1,
    20-1,000 and 57,344, p at the edges of the sums, NaN reads, NaN padding
    reads), and so does the plain version of phase B alone (site_reduce on
    CPU tensors)."""
    p, offsets, counts = fik.site_reduce_batch()
    assert {0, 1, 57344} <= set(counts.tolist()) and np.isnan(p[: counts.sum()]).sum() == 3
    assert sorted(set((offsets % 4).tolist())) == [0, 1, 2, 3]
    got = kernel_model(p, offsets, counts, DEFAULT_READ_THRESHOLD, n_samples)
    tp, tsid, tcnt = (torch.from_numpy(a) for a in (p, _site_ids(counts, len(p)), counts))
    want = (site_ops.site_probability_exact(tp, tsid, tcnt, len(counts), n_samples).numpy(),
            site_ops.mod_ratio_exact(tp, tsid, tcnt, len(counts), DEFAULT_READ_THRESHOLD).numpy())
    plain = fik.site_reduce(tp, torch.from_numpy(offsets), tcnt, DEFAULT_READ_THRESHOLD, n_samples)
    for a, b, c in zip(got, want, plain):
        assert _same_bits(a, b) and _same_bits(c.numpy(), b)
    # padding sites: site_p 1 (n_samples > 0) and mod_ratio 0; NaN reads: NaN site_p
    pad = counts == 0
    assert (got[0][pad] == (1.0 if n_samples else 0.0)).all() and (got[1][pad] == 0).all()
    assert np.isnan(got[0]).sum() == (3 if n_samples else 0)


def test_phase_b_plain_version_gives_nan_for_spans_that_leave_p():
    """The plain version of phase B alone, as the kernel: a negative offset
    or count, or a span past the last read, gives NaN for both outputs;
    every other site keeps its bits."""
    p, offsets, counts = fik.site_reduce_batch(nan_reads=False)
    want = fik.site_reduce_plain(*(torch.from_numpy(a) for a in (p, offsets, counts)), DEFAULT_READ_THRESHOLD)
    bad_offsets, bad_counts = offsets.copy(), counts.copy()
    bad_offsets[3], bad_counts[8], bad_offsets[9] = -1, -2, len(p) - 2
    got = fik.site_reduce(*(torch.from_numpy(a) for a in (p, bad_offsets, bad_counts)), DEFAULT_READ_THRESHOLD)
    bad = np.zeros(len(counts), bool)
    bad[[3, 8, 9]] = True
    for a, b in zip(got, want):
        assert a[bad].isnan().all() and torch.equal(a[~bad], b[~bad])
    model = kernel_model(p, bad_offsets, bad_counts, DEFAULT_READ_THRESHOLD, 20)
    assert all(_same_bits(m, a.numpy()) for m, a in zip(model, got))


def _long_site_batch(seed=4, n=65536):
    """pack_sites layout with a site of 57,344 reads, sites of one read and
    of 20-1,000, padding reads and padding sites."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(n, 3)).astype(np.int8)
    wanted = [57344, 1, 1] + rng.integers(20, 1001, size=12).tolist() + [1]
    counts, cursor = [], 0
    for c in wanted:
        if cursor + c > n - 100:
            break
        counts.append(c)
        cursor += c
    counts = np.array(counts + [0] * 4, np.int32)
    offsets = np.where(counts > 0, np.cumsum(counts) - counts, 0).astype(np.int32)
    return X, K, offsets, counts


def test_kernel_model_within_tolerance_of_the_jax_kernel(models):
    """On a batch with a 57,344-read site, sites of 1 and of 20-1,000 reads
    and padding: the port's plain phase A and the kernel model's sums
    against the JAX fused_inference_t (interpret mode): p 1e-6, site_p
    1e-5, mod_ratio equal but at sites holding a read within 1e-6 of the
    threshold.  (NaN reads are held against the site ops alone: the JAX
    kernel's one-hot contraction spreads a NaN to every site of the read's
    128-read sub-chunk.)"""
    (_, jax_params), port = models
    X, K, offsets, counts = _long_site_batch()
    assert counts[0] == 57344 and 1 in counts.tolist() and (counts == 0).any()
    want = [np.asarray(t) for t in jax_fused_inference_t(
        jax_prepare_fused_params_t(jax_params), jnp.asarray(X), jnp.asarray(K.astype(np.int32)),
        jnp.asarray(_site_ids(counts, len(X))), jnp.asarray(counts), DEFAULT_READ_THRESHOLD,
        interpret=True)]
    fp = fik.prepare_fused_params_t(port)
    p = fik.read_probability_plain(fp, torch.from_numpy(X), torch.from_numpy(K)).numpy()
    site_p, mod_ratio = kernel_model(p, offsets, counts, DEFAULT_READ_THRESHOLD, 20)
    np.testing.assert_allclose(p, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(site_p, want[1], rtol=0, atol=1e-5)
    near = np.bincount(_site_ids(counts, len(X)), weights=np.abs(p - DEFAULT_READ_THRESHOLD) < 1e-6,
                       minlength=len(counts) + 1)[:-1]
    hits_apart = np.abs(mod_ratio - want[2]) * np.maximum(counts, 1)
    assert (hits_apart <= near + 1e-3).all()
    np.testing.assert_array_equal(mod_ratio[near == 0], want[2][near == 0])


@pytest.mark.parametrize("bad_id,dtype", [(-1, np.int8), (66, np.int8), (127, np.int8), (261, np.int32)])
def test_host_kmer_check_raises_outside_the_vocabulary(bad_id, dtype):
    """checked_kmer_ids raises on an id outside [0, 66): negative int8 ids
    read as >= 128 in its one uint8 pass, and wider ids are checked before
    they are narrowed (261 would narrow to 5)."""
    ids = np.random.default_rng(1).integers(0, 66, size=(4096, 3)).astype(dtype)
    ids[1234, 2] = bad_id
    with pytest.raises(ValueError, match=r"kmer_ids must lie in \[0, 66\)"):
        fik.checked_kmer_ids(ids)


def test_host_kmer_check_passes_the_vocabulary_and_narrows():
    ids = np.tile(np.arange(66), 3).reshape(-1, 3)
    for dtype in (np.int8, np.int32, np.int64):
        checked = fik.checked_kmer_ids(ids.astype(dtype))
        assert checked.ids.dtype == np.int8 and (checked.ids == ids).all()
    same = ids.astype(np.int8)
    assert fik.checked_kmer_ids(same).ids is same  # int8 ids are not copied
    with pytest.raises(ValueError, match="integers"):
        fik.checked_kmer_ids(ids.astype(np.float32))


def test_wrappers_take_the_host_check(models):
    """The fused step and the encoder wrapper take checked_kmer_ids' result
    (and give the same outputs), and refuse anything else or another
    shape."""
    _, port = models
    fp = fik.prepare_fused_params_t(port)
    X, K, offsets, counts = _long_site_batch(n=4096)
    tX, tK, toff, tcnt = (torch.from_numpy(a) for a in (X, K, offsets, counts))
    host = fik.checked_kmer_ids(K)
    want = fik.fused_inference_t(fp, tX, tK, None, toff, tcnt, DEFAULT_READ_THRESHOLD)
    got = fik.fused_inference_t(fp, tX, tK, None, toff, tcnt, DEFAULT_READ_THRESHOLD, host_kmer_ids=host)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    p = encoder_kernel.fused_read_probability(fp, tX, tK, host_kmer_ids=host)
    assert torch.equal(p, want[0])
    with pytest.raises(TypeError, match="checked_kmer_ids"):
        fik.fused_inference_t(fp, tX, tK, None, toff, tcnt, DEFAULT_READ_THRESHOLD, host_kmer_ids=K)
    with pytest.raises(ValueError, match="host_kmer_ids have shape"):
        encoder_kernel.fused_read_probability(fp, tX, tK, host_kmer_ids=fik.checked_kmer_ids(K[1:]))


def test_engine_checks_kmer_ids_before_a_batch_is_dispatched(tmp_path, monkeypatch):
    """The engine checks each batch's k-mer ids on its pack thread: an id
    outside [0, 66) raises ValueError before that batch reaches the step,
    and every batch that is dispatched carries its checked host ids."""
    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MIN_READS, DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
    from m6anet_tpu_torch.data.dataset import build_dataset

    name = "HCT116_RNA002"
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        model = load_model(tomllib.load(f), PRETRAINED_CONFIGS[name][0])
    dataset = build_dataset(os.path.join(os.path.dirname(__file__), "data"), min_reads=DEFAULT_MIN_READS,
                            norm_path=PRETRAINED_CONFIGS[name][2], mode="Inference")
    real_pack, real_step = engine.pack_sites, engine.make_infer_step
    seen = []

    def bad_second_batch(*args, **kwargs):
        for i, batch in enumerate(real_pack(*args, **kwargs)):
            if i == 1:
                batch.kmer_ids[3, 1] = 66
            yield batch

    def counting_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def run(*a, **kw):
            seen.append(isinstance(kw.get("host_kmer_ids"), fik.CheckedKmerIds))
            return step(*a, **kw)

        return run

    monkeypatch.setattr(engine, "pack_sites", bad_second_batch)
    monkeypatch.setattr(engine, "make_infer_step", counting_step)
    with pytest.raises(ValueError, match="kmer_ids"):
        engine.run_inference(model, dataset, str(tmp_path), PRETRAINED_CONFIGS[name][1], device="cpu",
                             read_capacity=1024, site_capacity=8, pipeline_depth=1)
    assert seen == [True]


def test_production_batch_is_the_one_every_sweep_times():
    """_sweep.production_batch: 1,048,576 reads and 16,384 real sites packed
    from read 0 with counts from clip(gamma(2, 30), 20, 1000), features and
    k-mer ids drawn first from the seed (as the phase A sweeps drew theirs),
    padding reads after the last site."""
    features, kmer_ids, offsets, counts = _sweep.production_batch()
    assert features.shape == (_sweep.READS, 9) and kmer_ids.shape == (_sweep.READS, 3)
    assert counts.shape == (_sweep.SITES,) and counts.min() >= 20 and counts.max() <= 1000
    assert (offsets == np.cumsum(counts) - counts).all() and _sweep.READS - 60000 < counts.sum() <= _sweep.READS
    rng = np.random.default_rng(0)
    assert (features == rng.normal(size=(_sweep.READS, 9)).astype(np.float32)).all()
    assert (kmer_ids == rng.integers(0, 66, size=(_sweep.READS, 3)).astype(np.int8)).all()
    assert fik.checked_kmer_ids(kmer_ids).ids is kmer_ids


def test_sweep_rewrites_phase_as_tiling():
    """scripts/sweep_read_tile.py rewrites each of its seven constants (R,
    threads, blocks an SM, unroll, lanes a group G, the groups' unroll and
    the most values a read keeps where lanes group) once in fused_infer.cu,
    every variant keeps whole lane groups in a warp and whole warps in a
    block, the tiling as checked in is one of them, and each ablation finds
    each text it replaces once; its tail builds are the torch step's own
    (encoder_kernel.tail_defines of the signal-only model's 9 -> 150 ->
    32), where the source takes lane groups, and at the released widths
    it does not."""
    from m6anet_tpu_torch.ops import _build
    from m6anet_tpu_torch.scripts import sweep_read_tile as sweep

    path = os.path.join(os.path.dirname(fik.__file__), "csrc", "fused_infer.cu")
    with open(path) as f:
        text = f.read()
    assert "kLaneGroupTile" in sweep.CONSTANTS and len(set(sweep.VARIANTS)) == len(sweep.VARIANTS)
    for values in sweep.VARIANTS:
        reads, threads, blocks, unroll, group, group_unroll, group_values = values
        assert threads % 32 == 0 and group in (1, 2, 4) and min(reads, blocks, unroll, group_unroll) >= 1, values
        assert group_values >= 1, values
        rewritten = _sweep.variant_source(text, sweep.CONSTANTS, values, "fused_infer.cu")
        for name, value in zip(sweep.CONSTANTS, values):
            assert rewritten.count(f"constexpr int {name} = {value};") == 1
    checked_in = tuple(_build.cu_constants("fused_infer")[name] for name in sweep.CONSTANTS)
    assert checked_in in sweep.VARIANTS
    for label, edits in sweep.ABLATIONS:
        for old, new in edits:
            assert text.count(old) == 1 and old != new, (label, old)
        assert sweep.ablation_source(text, edits) != text
    with pytest.raises(SystemExit, match="no single"):
        sweep.ablation_source(text, [("this text is in no source", "")])
    tail = encoder_kernel.tail_defines(encoder_kernel.TailWidths(9, 150, 32))
    c = _build.cu_constants("fused_infer", tail)
    assert c["kIn"] == 9 and c["kReadValues"] <= c["kLaneGroupValues"] <= c["kReleasedReadValues"]
    assert c["kH2Pad"] % (4 * c["kLaneGroupTile"]) == 0
    released = _build.cu_constants("fused_infer")
    assert released["kReadValues"] > released["kLaneGroupValues"]


def test_sweep_rewrites_phase_bs_constants():
    """scripts/sweep_site_reduce.py rewrites each of its constants once in
    fused_infer.cu and every ablation finds its line; every build keeps a
    warp's sites whole (lanes a site: a power of two up to 32)."""
    from m6anet_tpu_torch.scripts import sweep_site_reduce as sweep

    path = os.path.join(os.path.dirname(fik.__file__), "csrc", "fused_infer.cu")
    with open(path) as f:
        text = f.read()
    for values in sweep.VARIANTS:
        assert values[1] in (1, 2, 4, 8, 16, 32) and values[0] % 32 == 0, values
        rewritten = _sweep.variant_source(text, sweep.CONSTANTS, values, "fused_infer.cu")
        for name, value in zip(sweep.CONSTANTS, values):
            assert f"constexpr int {name} = {value};" in rewritten
    for _, old, _ in sweep.ABLATIONS:
        assert text.count(old) == 1, old
    assert mc_kernel.MAX_STAGED_READS in fik.site_reduce_batch()[2].tolist()
