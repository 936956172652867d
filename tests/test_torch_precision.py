"""The port's reduced-precision modes, f32x3 and bf16, against the JAX
package's.

The JAX kernels run in Pallas interpret mode, as tests/test_ops.py runs
them; there the hi/lo splits are built by hand (encoder_kernel.py:160-178),
so the CPU computes the modes' real bf16 arithmetic.  On the CPU the port's
wrappers run their plain versions; the tensor-core kernel itself
(csrc/read_prob_tc.cu) is held against them on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances.  Against the JAX ``fused_inference_t`` in the same mode, run
eagerly on seeded reads: p 1e-6, site_p 1e-5 (f32 sums in another order;
the port sums 1 - p in f64), mod_ratio equal.  The demo slice against the
JAX engine holds p as ``assert_reads_close`` says (the JAX package's own
f32x3 p moves by up to 3.8e-6 between its jitted and eager kernel).
Against the JAX ``fused_read_probability`` and
``fused_inference``, whose own splits differ (f32x3 also on layer 1,
premultiplied embedding tables): the mode's tolerance against f32, 2e-5 for
f32x3 (tests/test_ops.py:429) and 2e-2 for bf16 (tests/test_ops.py:325)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from m6anet_tpu.constants import PRETRAINED_CONFIGS as JAX_PRETRAINED
from m6anet_tpu.data.dataset import build_dataset as jax_build_dataset
from m6anet_tpu.inference.engine import run_inference as jax_run_inference
from m6anet_tpu.ops.encoder_kernel import fused_read_probability as jax_fused_read_probability
from m6anet_tpu.ops.encoder_kernel import prepare_fused_params as jax_prepare_fused_params
from m6anet_tpu.ops.fused_infer_kernel import fused_inference as jax_fused_inference
from m6anet_tpu.ops.fused_infer_kernel import fused_inference_t as jax_fused_inference_t
from m6anet_tpu.ops.fused_infer_kernel import prepare_fused_params_t as jax_prepare_fused_params_t
from m6anet_tpu_torch.constants import DEFAULT_MIN_READS, DEFAULT_READ_THRESHOLD, PRETRAINED_CONFIGS
from m6anet_tpu_torch.data.batching import pack_sites
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.ops import _build, encoder_kernel
from m6anet_tpu_torch.ops import fused_infer_kernel as fik

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
MODES = ["f32x3", "bf16"]
JAX_DTYPE = {"f32x3": "f32x3", "bf16": jnp.bfloat16}
ENTRY_ATOL = {"f32x3": 2e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def models(production_model):
    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, DEFAULT_MODEL_WEIGHTS

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        port = load_model(tomllib.load(f), DEFAULT_MODEL_WEIGHTS)
    return production_model, port


def _packed_batch(seed=11, n=1024, s=96):
    """pack_sites layout with padding reads and padding sites (the inputs
    of tests/test_torch_fused_infer.py's parity tests)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(n, 3)).astype(np.int8)
    site_ids = np.full(n, s, np.int32)
    offsets = np.zeros(s, np.int32)
    counts = np.zeros(s, np.int32)
    cursor = 0
    for i in range(s):
        c = int(rng.integers(5, 20))
        if cursor + c > n:
            break
        site_ids[cursor : cursor + c] = i
        offsets[i], counts[i] = cursor, c
        cursor += c
    assert cursor < n and (counts == 0).any()
    return X, K, site_ids, offsets, counts


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("mode", MODES)
def test_plain_modes_match_jax_fused_inference_t(models, mode):
    """read_probability_plain, fused_inference_t_plain and the wrapper on
    CPU tensors against the JAX engine's kernel in the same mode."""
    (_, jax_params), port = models
    X, K, site_ids, offsets, counts = _packed_batch()
    want = jax_fused_inference_t(
        jax_prepare_fused_params_t(jax_params), jnp.asarray(X), jnp.asarray(K.astype(np.int32)),
        jnp.asarray(site_ids), jnp.asarray(counts), DEFAULT_READ_THRESHOLD,
        block_reads=256, interpret=True, compute_dtype=JAX_DTYPE[mode],
    )
    want = [np.asarray(w) for w in want]
    fp = fik.prepare_fused_params_t(port)
    tX, tK, toff, tcnt = _t(X, K, offsets, counts)
    launches = fik.launch_count, dict(fik.tc_launch_counts)
    p = fik.read_probability_plain(fp, tX, tK, mode)
    np.testing.assert_allclose(p.numpy(), want[0], rtol=0, atol=1e-6)
    for fn in (fik.fused_inference_t_plain, fik.fused_inference_t):
        got = fn(fp, tX, tK, None, toff, tcnt, DEFAULT_READ_THRESHOLD, 20, mode)
        assert torch.equal(got[0], p)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), want[2])
    # the mode is not f32: p moves, by about the mode's own error
    p32 = fik.read_probability_plain(fp, tX, tK)
    moved = float((p - p32).abs().max())
    assert (1e-7 < moved < 2e-5) if mode == "f32x3" else (1e-4 < moved < 2e-2)
    assert (fik.launch_count, fik.tc_launch_counts) == launches  # CPU tensors: no launch


@pytest.mark.parametrize("mode", MODES)
def test_entry_points_match_their_jax_kernels(models, mode):
    """fused_read_probability and fused_inference in a reduced mode against
    their own JAX kernels in that mode, at the mode's tolerance against
    f32 (their JAX splits differ from fused_inference_t's)."""
    (_, jax_params), port = models
    X, K, site_ids, offsets, counts = _packed_batch(seed=7)
    jfp = jax_prepare_fused_params(jax_params)
    want_p = np.asarray(jax_fused_read_probability(
        jfp, jnp.asarray(X), jnp.asarray(K.astype(np.int32)), block_reads=256, interpret=True,
        compute_dtype=JAX_DTYPE[mode]))
    want = [np.asarray(w) for w in jax_fused_inference(
        jfp, jnp.asarray(X), jnp.asarray(K.astype(np.int32)), jnp.asarray(site_ids), jnp.asarray(counts),
        DEFAULT_READ_THRESHOLD, block_reads=256, interpret=True, compute_dtype=JAX_DTYPE[mode])]
    fp = fik.prepare_fused_params_t(port)
    tol = ENTRY_ATOL[mode]
    p = encoder_kernel.fused_read_probability(fp, *_t(X, K), precision=mode)
    np.testing.assert_allclose(p.numpy(), want_p, rtol=0, atol=tol)
    got = fik.fused_inference(fp, *_t(X, K, site_ids, counts), DEFAULT_READ_THRESHOLD, precision=mode)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=max(tol, 1e-5))
    # the port's three entry points share fused_inference_t's arithmetic
    want_t = fik.fused_inference_t_plain(fp, *_t(X, K, site_ids, offsets, counts), DEFAULT_READ_THRESHOLD,
                                         precision=mode)
    assert torch.equal(p, want_t[0])
    for a, b in zip(got, want_t):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory, production_model):
    """The JAX engine's pallas_fused results on the demo data in each
    reduced mode, as (per-read p, site_p, mod_ratio) in CSV order, at 1024
    reads / 16 sites a batch.  f32x3 is the engine's own run.  XLA's CPU
    runtime cannot compile the jitted bf16 step's bf16 x bf16 -> f32 dots
    at this batch ("Unsupported element type for DotThunk"), so for bf16
    the step's two calls (derive_site_ids, then fused_inference_t) run
    eagerly on the engine's own batches."""
    from m6anet_tpu.data.batching import pack_sites as jax_pack_sites
    from m6anet_tpu.inference.engine import derive_site_ids as jax_derive_site_ids

    model, params = production_model
    _, thr, norm = JAX_PRETRAINED["HCT116_RNA002"]

    def dataset():
        return jax_build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")

    path = tmp_path_factory.mktemp("jax_f32x3")
    jax_run_inference(model, params, dataset(), str(path), read_proba_threshold=thr, read_capacity=1024,
                      site_capacity=16, use_mesh=False, backend="pallas_fused", precision="f32x3")
    indiv, site = pd.read_csv(path / "data.indiv_proba.csv"), pd.read_csv(path / "data.site_proba.csv")
    out = {"f32x3": (indiv.probability_modified.to_numpy(), site.probability_modified.to_numpy(),
                     site.mod_ratio.to_numpy())}
    fp = jax_prepare_fused_params_t(params)
    reads, sites, ratios = [], [], []
    for batch in jax_pack_sites(dataset().iter_sites(), read_capacity=1024, site_capacity=16):
        site_ids = jax_derive_site_ids(jnp.asarray(batch.offsets), jnp.asarray(batch.counts), 1024, 16)
        p, site_p, mod_ratio = jax_fused_inference_t(
            fp, jnp.asarray(batch.features), jnp.asarray(batch.kmer_ids.astype(np.int32)), site_ids,
            jnp.asarray(batch.counts), thr, interpret=True, compute_dtype=jnp.bfloat16)
        reads.append(np.asarray(p)[: int(batch.counts.sum())])
        sites.append(np.asarray(site_p)[: batch.n_sites])
        ratios.append(np.asarray(mod_ratio)[: batch.n_sites])
    out["bf16"] = tuple(np.concatenate(v) for v in (reads, sites, ratios))
    return out


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
@pytest.mark.parametrize("mode", MODES)
def test_demo_slice_matches_jax_engine(models, jax_demo, mode, backend):
    """The demo data through the port's CUDA-backend step in ``mode``, on
    CPU tensors and the JAX run's batches, against the JAX engine's
    pallas_fused path in the same mode: per read as assert_reads_close,
    site_p 1e-5, mod_ratio equal (the CSV's 16 decimals)."""
    _, port = models
    thr, norm = PRETRAINED_CONFIGS["HCT116_RNA002"][1:]
    ds = build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")
    step = engine.make_infer_step(port.eval(), 16, thr, backend=backend, precision=mode)
    reads, sites, ratios, n_batches = [], [], [], 0
    with torch.no_grad():
        for batch in pack_sites(ds.iter_sites(), read_capacity=1024, site_capacity=16):
            p, site_p, mod_ratio = step(*_t(batch.features, batch.kmer_ids.astype(np.int8),
                                            batch.offsets, batch.counts))
            reads.append(p[: int(batch.counts.sum())].numpy())
            sites.append(site_p[: batch.n_sites].numpy())
            ratios.append(mod_ratio[: batch.n_sites].numpy())
            n_batches += 1
    assert n_batches > 3  # several batches, padding in each
    want_p, want_site, want_ratio = jax_demo[mode]
    assert len(want_p) == sum(len(r) for r in reads) == 5595 and len(want_site) == 101
    assert_reads_close(np.concatenate(reads), want_p, mode)
    np.testing.assert_allclose(np.concatenate(sites), want_site, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.concatenate(ratios), want_ratio, rtol=0, atol=1e-12)


def assert_reads_close(got, want, mode):
    """Per-read p of a reduced mode against another implementation of it.
    f32x3: 5e-6.  The JAX package's own f32x3 p is reproducible only to
    ~4e-6: its jitted and eager kernel differ by up to 3.8e-6 on the demo's
    batches, as XLA orders the bf16x3 products' f32 sums by context.  bf16:
    every read within 1e-3 and 99.9% within 1e-6 — an f32 sum that differs
    in its last bit can round an activation to the neighbouring bf16 value."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if mode == "f32x3":
        assert err.max() <= 5e-6, err.max()
    else:
        assert err.max() <= 1e-3 and (err > 1e-6).mean() <= 1e-3, (err.max(), (err > 1e-6).sum())


def _tc_constants():
    """The ``constexpr int`` constants of csrc/read_prob_tc.cu, evaluated
    at the released widths (the macros' defaults)."""
    return _build.cu_constants("read_prob_tc")


def _bf16_pairs(words: torch.Tensor) -> torch.Tensor:
    """The two bf16 values of each int32 word (low half first), in f32."""
    halves = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], dim=-1)
    return (halves.to(torch.int32) << 16).view(torch.float32)


def test_tc_image_layout_matches_the_kernel(models):
    """The tensor-core image prepare_fused_params_t packs sits where
    read_prob_tc.cu reads it: offsets, padded widths and fragment orders
    from the .cu's constants; every padded unit packs zero weights and
    zero bias, and layer 1's bf16 operand never carries the bias."""
    _, port = models
    c = _tc_constants()
    fp = fik.prepare_fused_params_t(port)
    img = fp.tc
    wd, lay = fp.widths, fik.tc_layout(fp.widths)
    assert img.dtype == torch.int32 and img.numel() == c["kTcWords"] == lay["kTcWords"]
    for name in ("W1F", "EmbX", "W3L", "W2L", "W2H", "B2", "W3H", "B3", "W1H", "B1", "EmbH"):
        assert c[f"kTcOff{name}"] == lay[f"kTcOff{name}"], name
    assert (c["kH1Pad"], c["kKSteps"], c["kTiles1"], c["kTiles2"]) == (
        lay["kH1Pad"], lay["kKSteps"], lay["kTiles1"], lay["kTiles2"])
    pad = c["kH1Pad"] - wd.hidden1
    f32 = img.view(torch.float32)

    def part(name, n):
        return img[c[f"kTcOff{name}"] : c[f"kTcOff{name}"] + n]

    # f32x3 layer 1: [k step j][slot][quad q][thread t] float4 of row u
    w1b = torch.cat([fp.w1t, fp.b1t], dim=1)
    w1f = part("W1F", c["kH1Pad"] * 16).view(torch.float32).reshape(c["kKSteps"], 4, 4, 4, 4)
    for j in range(c["kKSteps"]):
        for slot in range(4):
            for t in range(4):
                u = 16 * j + 2 * t + (slot & 1) + 8 * (slot >> 1)
                row = w1f[j, slot, :, t].reshape(16)
                assert torch.equal(row, w1b[u]) if u < wd.hidden1 else not row.any(), (j, slot, t)
    # embeddings and the head
    emb = fp.embt.t()
    hi, lo = fik.bf16_split(emb)
    assert torch.equal(part("EmbX", 132).view(torch.float32).reshape(66, 2), hi + lo)
    assert torch.equal(part("EmbH", 132).view(torch.float32).reshape(66, 2), hi)
    w3_hi, w3_lo = fik.bf16_split(fp.w3t[0])
    assert torch.equal(part("W3H", 32).view(torch.float32), w3_hi)
    assert torch.equal(part("W3L", 32).view(torch.float32), w3_lo)
    assert torch.equal(part("B2", 32).view(torch.float32), fp.b2t[:, 0])
    assert f32[c["kTcOffB3"]] == fp.b3t[0, 0] and not img[c["kTcOffB3"] + 1 : c["kTcOffW1H"]].any()
    b1 = part("B1", c["kH1Pad"]).view(torch.float32)
    assert torch.equal(b1[: wd.hidden1], fp.b1t[:, 0]) and not b1[wd.hidden1 :].any()

    # wgmma B operands, K-major without swizzle: bf16 (n, k) of a k16 step at
    # byte (n // 8) SBO + (k // 8) LBO + (n % 8) row bytes + 2 (k % 8)
    def operand(name, n_steps, n_rows, step_bytes):
        vals = _bf16_pairs(img[c[f"kTcOff{name}"] :]).reshape(-1)  # bf16 values in byte order
        step, n, k = torch.meshgrid(torch.arange(n_steps), torch.arange(n_rows), torch.arange(16), indexing="ij")
        at = step * step_bytes + (n // 8) * c["kBSbo"] + (k // 8) * c["kBLbo"] + (n % 8) * c["kBRowBytes"] + 2 * (k % 8)
        return vals[at // 2]  # [step][n][k]

    w1k = torch.zeros(c["kH1Pad"], 16)
    w1k[: wd.hidden1, :15] = fp.w1t  # column 15 stays zero: never the bias
    assert torch.equal(operand("W1H", 1, c["kH1Pad"], 0)[0], fik.bf16_round(w1k))
    assert c["kTcOffB1"] - c["kTcOffW1H"] == c["kH1Pad"] * 16 // 2  # W1H fills its range
    w2k = torch.cat([fp.w2t, torch.zeros(wd.hidden2, pad)], dim=1)  # (32, 160)
    w2_hi, w2_lo = fik.bf16_split(w2k.reshape(wd.hidden2, c["kKSteps"], 16).permute(1, 0, 2))  # [step][n][k]
    for name, want in (("W2H", w2_hi), ("W2L", w2_lo)):
        assert torch.equal(operand(name, c["kKSteps"], c["kH2"], c["kW2StepBytes"]), want), name
    assert c["kKSteps"] * c["kW2StepBytes"] == 4 * (c["kTcOffW2H"] - c["kTcOffW2L"])  # W2L fills its range
    assert c["kW2StepBytes"] == c["kTiles2"] * c["kBSbo"] and c["kBSbo"] == 2 * c["kBLbo"] == 16 * c["kBRowBytes"]
    # each mode stages one contiguous, 16-byte aligned range; every operand
    # starts 16-byte aligned (a descriptor's address is in 16-byte units)
    assert c["kTcOffW2H"] % 4 == 0 and c["kTcOffW1H"] % 4 == 0 and c["kTcWords"] % 4 == 0
    assert c["kTcOffW2L"] % 4 == 0 and (c["kTcOffW1H"] - c["kTcOffW2H"]) % 4 == 0


_TC_MODE_NAMES = {"f32x3": "F32x3", "bf16": "Bf16"}  # the .cu's constants of each mode


def _tc_tile(mode):
    """Reads of one item of read_prob_tc.cu in ``mode`` (the tile_reads of
    its read_prob_tc_config): its 64-read tiles, from the .cu's constants."""
    c = _tc_constants()
    assert c["kTileReads"] == 64
    return c["kTileReads"] * c[f"k{_TC_MODE_NAMES[mode]}Tiles"]


@pytest.mark.parametrize("mode", MODES)
def test_ragged_tails_cover_the_tc_tile(mode):
    """ragged_tail_batches of the tensor-core kernel's tile in ``mode`` end
    it raggedly: the tile - 1 and tile + 1 reads, and past the reads a
    block's consumer warpgroups take at once; each batch's sites stay
    inside it."""
    c = _tc_constants()
    tile = _tc_tile(mode)
    sizes = [b[0].shape[0] for b in fik.ragged_tail_batches(tile)]
    assert {tile - 1, tile + 1} <= set(sizes)
    assert max(sizes) > c[f"k{_TC_MODE_NAMES[mode]}Consumers"] * tile + 1
    for X, K, offsets, counts in fik.ragged_tail_batches(tile):
        n = X.shape[0]
        assert K.shape == (n, 3) and int(counts.sum()) <= n
        assert ((offsets >= 0) & (offsets + counts <= n)).all()


@pytest.mark.parametrize("mode", MODES)
def test_modes_on_ragged_tails_and_narrow_ids(models, mode):
    """The cases the card checks the tensor-core kernel on, the ragged
    tails of its tile: on CPU tensors the wrapper is the plain version, int8
    and int32 k-mer ids give the same outputs, and padding sites give
    site_p 1."""
    _, port = models
    fp = fik.prepare_fused_params_t(port)
    for X, K, offsets, counts in fik.ragged_tail_batches(_tc_tile(mode)):
        args = (None, *_t(offsets, counts), DEFAULT_READ_THRESHOLD, 20, mode)
        got = fik.fused_inference_t(fp, *_t(X, K), *args)
        want = fik.fused_inference_t_plain(fp, *_t(X, K), *args)
        wide = fik.fused_inference_t(fp, *_t(X, K.astype(np.int32)), *args)
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, want, wide))
        assert (got[1][-2:] == 1.0).all()


def test_reduced_modes_need_a_cuda_backend_and_known_names(models):
    _, port = models
    with pytest.raises(ValueError, match="CUDA backends.*'torch'"):
        engine.make_infer_step(port, 4, DEFAULT_READ_THRESHOLD, backend="torch", precision="bf16")
    with pytest.raises(ValueError, match="precision must be one of"):
        engine.make_infer_step(port, 4, DEFAULT_READ_THRESHOLD, backend="cuda_fused", precision="auto")
    fp = fik.prepare_fused_params_t(port)
    X, K, site_ids, offsets, counts = _packed_batch()
    for call in (
        lambda: fik.fused_inference_t(fp, *_t(X, K), None, *_t(offsets, counts), 0.5, precision="f16"),
        lambda: fik.fused_inference(fp, *_t(X, K, site_ids, counts), 0.5, precision="tf32"),
        lambda: encoder_kernel.fused_read_probability(fp, *_t(X, K), precision="bf16x3"),
        lambda: fik.read_tile_reads("f64"),
    ):
        with pytest.raises(ValueError, match="precision must be one of"):
            call()


def test_cli_precision_flag(tmp_path, capsys):
    """--precision takes the JAX CLI's choices; on --device cpu (the torch
    backend) a reduced mode stops before any output is written."""
    from m6anet_tpu_torch.cli import main
    from m6anet_tpu_torch.scripts.inference import argparser

    base = ["--input_dir", DATA_DIR, "--out_dir", str(tmp_path / "out")]
    assert argparser().parse_args(base).precision == "auto"
    for mode in ("auto", "f32", "f32x3", "bf16"):
        assert argparser().parse_args(base + ["--precision", mode]).precision == mode
    with pytest.raises(SystemExit):
        argparser().parse_args(base + ["--precision", "f16"])
    assert "invalid choice" in capsys.readouterr().err
    for mode in MODES:
        with pytest.raises(ValueError, match="CUDA backends"):
            main(["inference", *base, "--device", "cpu", "--precision", mode, "--n_processes", "2"])
        assert not (tmp_path / "out" / "data.site_proba.csv").exists()


def test_sweep_rewrites_the_tc_kernels_constants(models):
    """scripts/sweep_read_prob_tc.py rewrites each of its constants once in
    read_prob_tc.cu, every ablation of the checked-in source finds its
    lines, and its ways of summing the tensor-core products give plain
    versions that agree with the checked-in one (the same function, summed
    otherwise)."""
    from unittest import mock

    from m6anet_tpu_torch.scripts import _sweep, sweep_read_prob_tc as sweep

    path = os.path.join(os.path.dirname(fik.__file__), "csrc", "read_prob_tc.cu")
    with open(path) as f:
        text = f.read()
    for values in sweep.VARIANTS:
        assert values[1] % values[0] == 0, values  # each stage serves one consumer warpgroup
        names, settings = sweep.variant_constants(values)
        rewritten = _sweep.variant_source(text, names, settings, "read_prob_tc.cu")
        for name, value in zip(names, settings):
            assert f"constexpr int {name} = {value};" in rewritten
    assert [name for name, _ in sweep.ablation_builds(text)] == list(sweep.ABLATIONS["wgmma"])
    _, port = models
    fp = fik.prepare_fused_params_t(port)
    X, K, *_ = _packed_batch()
    for mode in MODES:
        want = fik.read_probability_plain(fp, *_t(X, K), mode)
        for name, tensor_core_sum in sweep.SUMS.items():
            with mock.patch.object(fik, "_tensor_core_matmul", tensor_core_sum):
                got = fik.read_probability_plain(fp, *_t(X, K), mode)
            torch.testing.assert_close(got, want, rtol=0, atol=ENTRY_ATOL[mode], msg=name)
