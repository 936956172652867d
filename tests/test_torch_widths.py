"""The port's kernels at other widths of the production architecture than
the released models': positions P (3 P signal features), an embedding of E
dimensions, hidden widths H1 and H2, as a retrained m6anet.toml or dataprep
--n_neighbors gives them.

On the CPU every wrapper runs its plain version; the JAX kernels run in
Pallas interpret mode, as tests/test_ops.py runs them.  W0-W7 are
``chip_smoke.py`` phase 21's and W8-W12 phase 23's (past the widths of the
kernels' fast plans: H1 = 512, H2 = 128, 121 inputs a read, a vocabulary of
1,024 k-mers), which hold the CUDA kernels against the same plain versions
on the card.  Tolerances (PERF.md section 2, the CPU row):
p 1e-6 and site_p 1e-5 in every precision against ``fused_inference_t``,
mod_ratio equal but at reads within 1e-6 of the threshold; the entry points
of another JAX split (``fused_read_probability``, ``fused_inference``) at
their reduced mode's tolerance against f32 (2e-5 f32x3, 2e-2 bf16), as
tests/test_torch_precision.py holds them at the released widths.  The
JAX parameters are prepared with ``n_features = 3 P``: at the default 9,
which the JAX engine passes, its ``prepare_fused_params_t`` refuses the
widths where E does not divide 3 (P - 3), W7 among them.
"""
import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from m6anet_tpu.data.dataset import build_dataset as jax_build_dataset
from m6anet_tpu.inference.engine import run_inference as jax_run_inference
from m6anet_tpu.models.mil import MILModel as JaxMILModel
from m6anet_tpu.ops.encoder_kernel import fused_read_probability as jax_fused_read_probability
from m6anet_tpu.ops.encoder_kernel import prepare_fused_params as jax_prepare_fused_params
from m6anet_tpu.ops.fused_infer_kernel import fused_inference as jax_fused_inference
from m6anet_tpu.ops.fused_infer_kernel import fused_inference_t as jax_fused_inference_t
from m6anet_tpu.ops.fused_infer_kernel import prepare_fused_params_t as jax_prepare_fused_params_t
from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.dataprep.runner import run_dataprep
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.inference.outputs import compare_runs
from m6anet_tpu_torch.models.convert import params_from_jax
from m6anet_tpu_torch.models.mil import MILModel
from m6anet_tpu_torch.ops import _build, encoder_kernel
from m6anet_tpu_torch.ops import fused_infer_kernel as fik

WIDTHS = {"W0": (3, 2, 150, 32), "W1": (5, 2, 150, 32), "W2": (3, 3, 100, 20), "W3": (3, 4, 256, 64),
          "W4": (11, 4, 96, 24), "W5": (1, 1, 7, 3), "W6": (11, 4, 256, 64), "W7": (1, 4, 256, 64),
          "W8": (3, 2, 512, 32), "W9": (3, 2, 150, 128), "W10": (11, 8, 256, 64), "W11": (3, 2, 150, 32, 1024),
          "W12": (11, 8, 512, 128, 1024)}
PRECISIONS = ["f32", "f32x3", "bf16"]
JAX_DTYPE = {"f32": jnp.float32, "f32x3": "f32x3", "bf16": jnp.bfloat16}
ENTRY_ATOL = {"f32": 1e-6, "f32x3": 2e-5, "bf16": 2e-2}
THRESHOLD = 0.5


def _models(widths, seed=0):
    """A JAX model of ``widths`` with params from its own init and
    BatchNorm statistics and affine drawn from ``seed`` (so that the fold
    into layer 1 is no identity), and the port's model with the same
    weights, carried across by models/convert.py."""
    config = fik.widths_config(fik.Widths(*widths))
    jax_model = JaxMILModel(config)
    params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    bn = params["block3"]
    n = bn["bn_mean"].shape[0]
    bn["bn_mean"] = (0.2 * rng.normal(size=n)).astype(np.float32)
    bn["bn_var"] = (0.5 + rng.uniform(size=n)).astype(np.float32)
    bn["bn_scale"] = (1 + 0.2 * rng.normal(size=n)).astype(np.float32)
    bn["bn_bias"] = (0.2 * rng.normal(size=n)).astype(np.float32)
    port = MILModel(config)
    port.load_state_dict(params_from_jax(params))
    return jax_model, jax.tree.map(jnp.asarray, params), port.eval()


@pytest.fixture(scope="module")
def width_models():
    return {name: _models(widths) for name, widths in WIDTHS.items()}


def _batch(widths, seed=5, n=384, s=40):
    """pack_sites layout at ``widths``: sites of 1 to 19 reads, padding reads
    and padding sites; k-mer ids over the model's vocabulary (int16 past
    128 k-mers)."""
    rng = np.random.default_rng(seed)
    w = fik.Widths(*widths)
    X = rng.normal(size=(n, w.features)).astype(np.float32)
    K = rng.integers(0, w.vocab, size=(n, w.positions)).astype(fik.kmer_dtype(w.vocab))
    site_ids = np.full(n, s, np.int32)
    offsets = np.zeros(s, np.int32)
    counts = np.zeros(s, np.int32)
    cursor = 0
    for i in range(s - 4):
        c = 1 if i % 7 == 0 else int(rng.integers(2, 20))
        if cursor + c > n - 16:
            break
        site_ids[cursor : cursor + c] = i
        offsets[i], counts[i] = cursor, c
        cursor += c
    return X, K, site_ids, offsets, counts


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", WIDTHS)
def test_weights_carried_across_give_the_jax_kernels_parameters(width_models, name):
    """models/convert.py carries a JAX model of each width into the port,
    and the port's FusedParamsT is the JAX FusedEncoderParamsT, with the
    widths read from the model: the same f32 values, bit for bit but in
    the BatchNorm fold, where XLA fuses (b - mean) * scale + bias into one
    multiply-add: there within 1e-7 (an ulp at 1)."""
    _, params, port = width_models[name]
    fp = fik.prepare_fused_params_t(port)
    want = jax_prepare_fused_params_t(params, n_features=3 * WIDTHS[name][0])
    assert fp.widths == fik.Widths(*WIDTHS[name])
    for field in want._fields:
        got, jax_value = getattr(fp, field).numpy(), np.asarray(getattr(want, field))
        assert got.shape == jax_value.shape, field
        if field in ("w1t", "b1t"):
            np.testing.assert_allclose(got, jax_value, rtol=2e-7, atol=1e-7, err_msg=field)
        else:
            np.testing.assert_array_equal(got, jax_value, err_msg=field)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", WIDTHS)
def test_plain_versions_match_jax_fused_inference_t(width_models, name, precision):
    """The port's fused_inference_t on CPU tensors (its plain version)
    against the JAX kernel at the same widths and compute_dtype."""
    _, params, port = width_models[name]
    X, K, site_ids, offsets, counts = _batch(WIDTHS[name])
    want = [np.asarray(w) for w in jax_fused_inference_t(
        jax_prepare_fused_params_t(params, n_features=3 * WIDTHS[name][0]), jnp.asarray(X), jnp.asarray(K.astype(np.int32)),
        jnp.asarray(site_ids), jnp.asarray(counts), THRESHOLD, block_reads=256, interpret=True,
        compute_dtype=JAX_DTYPE[precision])]
    fp = fik.prepare_fused_params_t(port)
    launches = fik.launch_count, dict(fik.tc_launch_counts)
    p, site_p, mod_ratio = (t.numpy() for t in fik.fused_inference_t(
        fp, *_t(X, K), None, *_t(offsets, counts), THRESHOLD, 20, precision))
    np.testing.assert_allclose(p, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(site_p, want[1], rtol=0, atol=1e-5)
    near = np.abs(p - THRESHOLD) < 1e-6
    sites_near = np.zeros(len(counts) + 1, bool)
    np.logical_or.at(sites_near, site_ids, near)
    np.testing.assert_array_equal(mod_ratio[~sites_near[:-1]], want[2][~sites_near[:-1]])
    with torch.no_grad():
        model_p = port.per_read_probability({"X": torch.from_numpy(X), "kmer": torch.from_numpy(K)}).numpy()
    np.testing.assert_allclose(p, model_p, rtol=0, atol=1e-6 if precision == "f32" else ENTRY_ATOL[precision])
    assert (fik.launch_count, fik.tc_launch_counts) == launches  # CPU tensors: no launch


@pytest.mark.parametrize("precision", PRECISIONS)
def test_entry_points_at_w3_match_their_jax_kernels(width_models, precision):
    """fused_read_probability and fused_inference at W3 against their own
    JAX kernels: f32 at 1e-6, a reduced mode at its tolerance against f32
    (their JAX splits differ from fused_inference_t's)."""
    _, params, port = width_models["W3"]
    X, K, site_ids, offsets, counts = _batch(WIDTHS["W3"], seed=8, n=512)
    jfp = jax_prepare_fused_params(params)
    want_p = np.asarray(jax_fused_read_probability(
        jfp, jnp.asarray(X), jnp.asarray(K.astype(np.int32)), block_reads=256, interpret=True,
        compute_dtype=JAX_DTYPE[precision]))
    want = [np.asarray(w) for w in jax_fused_inference(
        jfp, jnp.asarray(X), jnp.asarray(K.astype(np.int32)), jnp.asarray(site_ids), jnp.asarray(counts),
        THRESHOLD, block_reads=256, interpret=True, compute_dtype=JAX_DTYPE[precision])]
    fp = encoder_kernel.prepare_fused_params(port)
    tol = ENTRY_ATOL[precision]
    p = encoder_kernel.fused_read_probability(fp, *_t(X, K), precision).numpy()
    np.testing.assert_allclose(p, want_p, rtol=0, atol=tol)
    got = [t.numpy() for t in fik.fused_inference(fp, *_t(X, K, site_ids, counts), THRESHOLD, 20, precision)]
    np.testing.assert_array_equal(got[0], p)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5 + 20 * tol)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_entry_points_at_w12_take_int32_ids_over_the_vocabulary(width_models, precision):
    """fused_read_probability and fused_inference at W12 (11 positions,
    E = 8, H1 = 512, H2 = 128, 1,024 k-mers) with int32 k-mer ids up to V
    - 1 against their own JAX kernels, as at W3; and fused_inference_t's
    plain version takes the same ids as int16, the type the kernels read
    them in, with the same p."""
    _, params, port = width_models["W12"]
    w = fik.Widths(*WIDTHS["W12"])
    X, K, site_ids, offsets, counts = _batch(WIDTHS["W12"], seed=9, n=256, s=24)
    K = K.astype(np.int32)
    K[0] = w.vocab - 1
    assert K.max() == w.vocab - 1 and (K >= 128).mean() > 0.8
    jfp = jax_prepare_fused_params(params, n_features=w.features)
    want_p = np.asarray(jax_fused_read_probability(
        jfp, jnp.asarray(X), jnp.asarray(K), block_reads=256, interpret=True, compute_dtype=JAX_DTYPE[precision]))
    want = [np.asarray(v) for v in jax_fused_inference(
        jfp, jnp.asarray(X), jnp.asarray(K), jnp.asarray(site_ids), jnp.asarray(counts), THRESHOLD,
        block_reads=256, interpret=True, compute_dtype=JAX_DTYPE[precision])]
    fp = encoder_kernel.prepare_fused_params(port)
    tol = ENTRY_ATOL[precision]
    p = encoder_kernel.fused_read_probability(fp, *_t(X, K), precision).numpy()
    np.testing.assert_allclose(p, want_p, rtol=0, atol=tol)
    got = [t.numpy() for t in fik.fused_inference(fp, *_t(X, K, site_ids, counts), THRESHOLD, 20, precision)]
    np.testing.assert_array_equal(got[0], p)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5 + 20 * tol)
    host = fik.checked_kmer_ids(K, w.vocab)
    assert host.ids.dtype == np.int16 and (host.ids == K).all()
    p16, *_ = fik.fused_inference_t(fp, *_t(X, host.ids), None, *_t(offsets, counts), THRESHOLD, 20, precision,
                                    host_kmer_ids=host)
    np.testing.assert_array_equal(p16.numpy(), p)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_kmer_ids_reach_the_kernels_as_int8_or_int16(width_models, dtype):
    """The kernels read int8 ids where every id is below 128 and int16
    otherwise: checked_kmer_ids returns that type, and the device check
    finds it (its ``>= vocab`` and ``>= 128`` tests hold in every id type,
    where torch compares in the ids' own); at W11 (1,024 k-mers) the
    dataset's int8 ids pass the check and give the int16 ids' p."""
    _, _, port = width_models["W11"]
    fp = fik.prepare_fused_params_t(port)
    X, K16, _, offsets, counts = _batch(WIDTHS["W11"], seed=11)  # ids over the 1,024, int16
    low = (K16 % 66).astype(dtype)  # the dataset's ids
    assert fik.checked_kmer_ids(low, 1024).ids.dtype == np.int8
    assert not fik._check_kmer_range(torch.from_numpy(low), vocab=1024)
    if dtype != np.int8:
        high = K16.astype(dtype)
        assert fik.checked_kmer_ids(high, 1024).ids.dtype == np.int16
        assert fik._check_kmer_range(torch.from_numpy(high), vocab=1024)
    got = fik.fused_inference_t(fp, *_t(X, low), None, *_t(offsets, counts), THRESHOLD)
    want = fik.fused_inference_t(fp, *_t(X, low.astype(np.int16)), None, *_t(offsets, counts), THRESHOLD)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad, vocab in ((1024, 1024), (66, 66), (-1, 1024)):
        if bad > np.iinfo(dtype).max:
            continue
        ids = low.copy()
        ids[3, 1] = bad
        with pytest.raises(ValueError, match=rf"kmer_ids must lie in \[0, {vocab}\)"):
            fik._check_kmer_range(torch.from_numpy(ids), vocab=vocab)


def _bf16_pairs(words: torch.Tensor) -> torch.Tensor:
    """The two bf16 values of each int32 word (low half first), in f32."""
    halves = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], dim=-1)
    return (halves.to(torch.int32) << 16).view(torch.float32)


@pytest.mark.parametrize("name", WIDTHS)
def test_packed_images_sit_where_the_kernels_read_them(width_models, name):
    """Both weight images at each width against the .cu's constants, as a
    build with the width's defines evaluates them (kernel_defines): f32's
    rows and fan-outs, and the tensor-core image's f32x3 layer-1 rows in
    their lanes' order and every wgmma B operand decoded by its
    descriptor's layout; every padded unit and column zero."""
    _, _, port = width_models[name]
    fp = fik.prepare_fused_params_t(port)
    w = fp.widths
    defines = fik.kernel_defines(w)
    assert (defines == {}) == (name == "W0")
    c = _build.cu_constants("fused_infer", defines)
    lay = fik.f32_layout(w)
    assert {k: c[k] for k in lay} == lay and fp.packed.numel() == lay["kWeights"]
    assert (c["kIn"], c["kH1"], c["kH2"], c["kVocab"], c["kEmb"]) == (w.n_in, w.hidden1, w.hidden2, w.vocab, w.emb)
    img = fp.packed
    w1b = img[: w.hidden1 * c["kW1Stride"]].reshape(w.hidden1, c["kW1Stride"])
    assert torch.equal(w1b[:, : w.n_in], fp.w1t) and torch.equal(w1b[:, w.n_in], fp.b1t[:, 0])
    assert not w1b[:, w.n_in + 1 :].any()
    emb = img[c["kOffEmb"] : c["kOffEmb"] + w.vocab * w.emb].reshape(w.vocab, w.emb)
    assert torch.equal(emb, fp.embt.t()) and not img[c["kOffEmb"] + w.vocab * w.emb : c["kOffW2"]].any()
    w2 = img[c["kOffW2"] : c["kOffB2"]].reshape(w.hidden1, c["kH2Pad"])
    assert torch.equal(w2[:, : w.hidden2], fp.w2t.t()) and not w2[:, w.hidden2 :].any()
    for off, want in (("kOffB2", fp.b2t[:, 0]), ("kOffW3", fp.w3t[0])):
        part = img[c[off] : c[off] + c["kH2Pad"]]
        assert torch.equal(part[: w.hidden2], want) and not part[w.hidden2 :].any()
    assert img[c["kOffB3"]] == fp.b3t[0, 0] and not img[c["kOffB3"] + 1 :].any()

    t = _build.cu_constants("read_prob_tc", defines)
    lay = fik.tc_layout(w)
    assert {k: t[k] for k in lay} == lay and fp.tc.numel() == lay["kTcWords"]
    image, f32 = fp.tc, fp.tc.view(torch.float32)
    h1p, h2p, steps, k1 = t["kH1Pad"], t["kH2Pad"], t["kKSteps"], t["kK1Steps"]
    rows = torch.zeros(h1p, t["kW1Stride"])
    rows[: w.hidden1, : w.n_in], rows[: w.hidden1, w.n_in] = fp.w1t, fp.b1t[:, 0]
    w1f = f32[: t["kTcOffEmbX"]].reshape(steps, 4, t["kW1Quads"], 4, 4)  # [j][c][q][t][4]
    for j, slot, lane in itertools.product(range(steps), range(4), range(4)):
        u = 16 * j + 2 * lane + (slot & 1) + 8 * (slot >> 1)
        assert torch.equal(w1f[j, slot, :, lane].reshape(-1), rows[u]), (j, slot, lane)
    # the same rows input-major (f32x3's wide plan), the bias the last row
    assert torch.equal(f32[t["kTcOffW1T"] : t["kTcWords"]].reshape(w.n_in + 1, h1p), rows[:, : w.n_in + 1].t())

    def padded(off, n, want):
        part = f32[t[off] : t[off] + n]
        return torch.equal(part[: want.numel()], want) and not part[want.numel() :].any()

    hi, lo = fik.bf16_split(fp.embt.t().reshape(-1))
    w3_hi, w3_lo = fik.bf16_split(fp.w3t[0])
    assert padded("kTcOffEmbX", t["kEmbWords"], hi + lo) and padded("kTcOffEmbH", t["kEmbWords"], hi)
    assert padded("kTcOffW3L", h2p, w3_lo) and padded("kTcOffW3H", h2p, w3_hi)
    assert padded("kTcOffB2", h2p, fp.b2t[:, 0]) and padded("kTcOffB1", h1p, fp.b1t[:, 0])
    assert padded("kTcOffB3", 4, fp.b3t[0])

    def operand(off, n_steps, n_rows, step_bytes):
        vals = _bf16_pairs(image[t[off] :]).reshape(-1)
        step, n, k = torch.meshgrid(torch.arange(n_steps), torch.arange(n_rows), torch.arange(16), indexing="ij")
        at = step * step_bytes + (n // 8) * t["kBSbo"] + (k // 8) * t["kBLbo"] + (n % 8) * t["kBRowBytes"] + 2 * (k % 8)
        return vals[at // 2]  # [step][n][k]

    w1k = torch.zeros(h1p, 16 * k1)
    w1k[: w.hidden1, : w.n_in] = fp.w1t  # never the bias
    assert torch.equal(operand("kTcOffW1H", k1, h1p, t["kW1StepBytes"]),
                       fik.bf16_round(w1k).reshape(h1p, k1, 16).permute(1, 0, 2))
    w2k = torch.zeros(h2p, h1p)
    w2k[: w.hidden2, : w.hidden1] = fp.w2t
    w2_hi, w2_lo = fik.bf16_split(w2k.reshape(h2p, steps, 16).permute(1, 0, 2))
    assert torch.equal(operand("kTcOffW2H", steps, h2p, t["kW2StepBytes"]), w2_hi)
    assert torch.equal(operand("kTcOffW2L", steps, h2p, t["kW2StepBytes"]), w2_lo)
    for off in ("kTcOffW2L", "kTcOffW2H", "kTcOffW1H", "kTcOffW1T", "kTcWords"):
        assert t[off] % 4 == 0, off  # 16-byte aligned: a descriptor's address is in 16-byte units


def test_the_envelope_on_the_card():
    """resolve_backend on the card: cuda_fused for the production
    architecture at every P of SiteDataset, E <= 4 and the corners of H1
    <= 256 and H2 <= 64, and past them (the widths the kernels refused
    before their wide plans, W8-W12), in every precision on both CUDA
    backends; a vocabulary past the int16 k-mer ids, a ValueError before
    anything launches that names the widths, the limit and --backend
    torch."""
    cuda = torch.device("cuda")
    past = [WIDTHS[name] for name in ("W8", "W9", "W10", "W11", "W12")]
    past += [(3, 2, 257, 32), (3, 2, 150, 65), (11, 5, 256, 64), (3, 2, 150, 32, 200), (3, 2, 150, 32, 32767)]
    within = [(positions, emb, h1, h2) for positions, emb, (h1, h2) in itertools.product(
        (1, 3, 5, 7, 9, 11), (1, 2, 3, 4), ((1, 1), (7, 3), (150, 32), (256, 64), (96, 24)))]
    for widths in within + past:
        model = MILModel(fik.widths_config(fik.Widths(*widths)))
        assert fik.kernel_limit(fik.model_widths(model)) is None
        assert engine.resolve_backend(model, "auto", "auto", cuda) == ("cuda_fused", "f32x3")
        assert engine.resolve_backend(model, "cuda", "bf16", cuda) == ("cuda", "bf16")
        if widths in past:
            for backend, precision in itertools.product(("cuda_fused", "cuda"), PRECISIONS):
                assert engine.resolve_backend(model, backend, precision, cuda) == (backend, precision)
    widths, limit = (3, 2, 150, 32, 32768), "int16 k-mer ids"
    model = MILModel(fik.widths_config(fik.Widths(*widths)))
    assert engine.production_architecture(model) and limit in fik.kernel_limit(fik.model_widths(model))
    for backend in ("auto", "cuda_fused", "cuda"):
        with pytest.raises(ValueError, match=f"hidden {widths[2]} -> {widths[3]}.*{limit}.*--backend torch"):
            engine.resolve_backend(model, backend, "auto", cuda)
    assert engine.resolve_backend(model, "torch", "auto", cuda) == ("torch", "f32")


PLAN_KEYS = ("reads", "read_blocks", "f32x3_tiles", "f32x3_stages", "f32x3_x_shared", "f32x3_smem",
             "bf16_consumers", "bf16_stages", "bf16_smem", "f32_wide", "f32x3_wide", "bf16_wide",
             "f32_wide_reads", "f32_wide_threads", "f32_wide_smem", "f32_wide_unit_steps", "f32_wide_cols",
             "f32_wide_in_steps", "f32_wide_pass", "f32_wide_passes", "f32_wide_l1_threads", "f32_wide_l2_threads",
             "tc_wide_reads", "tc_wide_pass_tiles", "tc_wide_passes", "f32x3_wide_smem", "f32x3_wide_cols",
             "f32x3_wide_in_steps", "bf16_wide_smem", "bf16_wide_cols", "bf16_wide_in_steps")


def _source_constants(name):
    """What csrc/<name>.cu holds before its first device function: its
    widths' macros used, its constants and plan, host C++ alone."""
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        text = f.read()
    body = text[text.index("namespace {") + len("namespace {") :]
    return body[: re.search(r"^(template <.*>\n)?(__global__|__device__|// -{10})", body, re.M).start()]


def _source_plans(widths, work):
    """The tiling that csrc/fused_infer.cu and csrc/read_prob_tc.cu derive
    at each of ``widths``, by ``PLAN_KEYS``: their constants (everything
    before the first device function) compiled for the host with g++, one
    namespace a set of widths, in one program.  A plan past the shared
    memory of a block fails the sources' static_assert, so the build.
    ``*_wide`` is 1 where a phase A takes its wide plan."""
    import subprocess

    f32, tc = _source_constants("fused_infer"), _source_constants("read_prob_tc")
    parts, prints = ["#include <cstdint>\n#include <cstdio>\n"], []
    for i, w in enumerate(widths):
        defines = {"M6A_POS": w.positions, "M6A_EMB": w.emb, "M6A_VOCAB": w.vocab, "M6A_H1": w.hidden1,
                   "M6A_H2": w.hidden2, "M6A_KMER_ID_BYTES": 1 if w.vocab <= 128 else 2}
        parts += [f"#undef {k}\n#define {k} {v}\n" for k, v in defines.items()]
        parts += [f"namespace f{i} {{\n{f32}}}\nnamespace t{i} {{\n{tc}}}\n"]
        a, b = f"t{i}::Cfg<t{i}::kModeF32x3>", f"t{i}::Cfg<t{i}::kModeBf16>"
        x3, bf = f"t{i}::wide_plan(true)", f"t{i}::wide_plan(false)"
        values = [f"f{i}::kReads", f"f{i}::kReadBlocks", f"{a}::kTilesPerGroup", f"{a}::kStages",
                  f"(int){a}::kXShared", f"{a}::kSmemBytes", f"{b}::kConsumers", f"{b}::kStages", f"{b}::kSmemBytes",
                  f"(int)f{i}::kWide", f"(int){a}::kWide", f"(int){b}::kWide",
                  f"f{i}::kWideReads", f"f{i}::kWideThreads", f"f{i}::kWideSmem", f"f{i}::kWideUnitSteps",
                  f"f{i}::kWideCols", f"f{i}::kWideInSteps", f"f{i}::kWidePass", f"f{i}::kWidePasses",
                  f"f{i}::kL1Tr * f{i}::kL1Tn", f"f{i}::kL2Tr * f{i}::kL2Tn",
                  f"t{i}::kTcWideReads", f"t{i}::kWidePassTiles", f"t{i}::kWidePasses", f"{x3}.smem", f"{x3}.cols",
                  f"{x3}.in_steps", f"{bf}.smem", f"{bf}.cols", f"{bf}.in_steps"]
        prints.append(f'  std::printf("{" ".join(["%d"] * len(values))}\\n", {", ".join(values)});')
    parts.append("int main() {\n" + "\n".join(prints) + "\n}\n")
    src, exe = os.path.join(work, "plans.cpp"), os.path.join(work, "plans")
    with open(src, "w") as f:
        f.write("".join(parts))
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", exe, src], check=True, capture_output=True)
    out = subprocess.run([exe], check=True, capture_output=True, text=True).stdout.split("\n")
    return [dict(zip(PLAN_KEYS, map(int, line.split()))) for line in out[: len(widths)]]


def test_kernel_plan_keeps_the_sources_tuning_at_the_released_widths(tmp_path):
    """The released widths build with no defines, and the sources' plan
    there is the constants the sweeps tuned (f32x3's shared memory as
    read_prob_tc_config reports it on the card); at W1-W7 the plan is the
    one that phase 21 ran, none of them wide; W8-W12 take the wide plans
    where they pass a fast plan's registers or shared memory (f32 past 144
    values a read or a 227 KB image, the tensor-core modes past H1 = 256,
    H2 = 64 or a block's shared memory), W11 the fast plans with int16 ids;
    over the grid of P in {1, 3, 5, 11}, E in {1, 4, 8}, H1 in {1, 150,
    256, 512}, H2 in {1, 32, 64, 128} and V in {66, 1024} every plan builds
    (a fast plan's shared memory fits a block, a wide plan's inputs fit),
    f32 phase A takes 1 read a thread past the released widths' 47 values
    a read, and kernel_limit takes the widths.  Over the grid and at the
    edges of kernel_limit (1,816 inputs a read; H1 = 1, H2 = 1; 32,767
    k-mers) every wide plan fits a block's shared memory and its steps
    cover the widths as the wide kernels assume: H1 in unit chunks, n_in
    and the bias in layer-1 columns (f32, f32x3) or n_in in k16 steps
    (bf16), H2 (to 4) in passes of a power of two of outputs at least 16
    (f32) or of n8 tiles (f32x3, bf16), each with no step past the last
    one needed; f32's layer-1 micro-tiles cover the block's threads, its
    layer-2 micro-tiles fit them."""
    assert fik.kernel_defines(fik.PRODUCTION) == {}
    assert fik.kernel_defines(fik.PRODUCTION, 2) == {"M6A_KMER_ID_BYTES": 2}
    c, t = _build.cu_constants("fused_infer"), _build.cu_constants("read_prob_tc")
    released = dict(reads=c["kReadTile"], read_blocks=c["kReadMinBlocks"], f32x3_tiles=t["kF32x3Tiles"],
                    f32x3_stages=t["kF32x3Stages"], f32x3_x_shared=0, f32x3_smem=51808,
                    bf16_consumers=t["kBf16Consumers"], bf16_stages=t["kBf16Stages"], bf16_smem=24432,
                    f32_wide=0, f32x3_wide=0, bf16_wide=0, f32_wide_reads=c["kWideReads"],
                    f32_wide_threads=c["kWideThreads"], tc_wide_reads=16 * t["kTcWideWarps"])
    grid = [fik.Widths(*w) for w in itertools.product((1, 3, 5, 11), (1, 4, 8), (1, 150, 256, 512),
                                                      (1, 32, 64, 128), (66, 1024))]
    edges = [fik.Widths(*w) for w in itertools.product((227,), (5,), (1, 512), (1, 128, 129), (66, 32767))]
    edges += [fik.Widths(1, 1, 1, 1, 1), fik.Widths(3, 2, 4096, 1000), fik.Widths(3, 2, 150, 65)]
    assert max(w.n_in for w in edges) == fik.MAX_N_IN
    card = [fik.Widths(*w) for w in WIDTHS.values()]
    plans = _source_plans([fik.PRODUCTION] + card + grid + edges, str(tmp_path))
    assert {k: plans[0][k] for k in released} == released
    narrow = [k for k in PLAN_KEYS if "smem" not in k and "wide" not in k]
    # (reads, blocks an SM, f32x3 tiles / stages / rows, bf16 warpgroups / stages) at W1-W7
    assert [tuple(plan[k] for k in narrow) for plan in plans[2:9]] == [
        (1, 2, 2, 4, 1, 3, 3), (2, 2, 2, 4, 1, 3, 3), (1, 2, 1, 4, 0, 2, 4), (1, 1, 1, 4, 1, 3, 3),
        (2, 2, 2, 4, 0, 3, 3), (1, 1, 1, 4, 1, 2, 4), (1, 2, 1, 4, 0, 2, 4)]
    wide_keys = ("f32_wide", "f32x3_wide", "bf16_wide")
    assert [tuple(plan[k] for k in wide_keys) for plan in plans[1:9]] == [(0, 0, 0)] * 8
    # (f32, f32x3, bf16) wide at W8-W12
    assert [tuple(plan[k] for k in wide_keys) for plan in plans[9:14]] == [
        (0, 1, 1), (0, 1, 1), (1, 1, 0), (0, 0, 0), (1, 1, 1)]
    # W11 (W0 at 1,024 k-mers, int16 ids): W0's plan, with stages 128 bytes longer an item's tile
    assert {k: plans[12][k] for k in narrow} == {k: plans[1][k] for k in narrow}
    for w, plan in zip(card + grid + edges, plans[1:]):
        assert fik.kernel_limit(w) is None, w
        assert plan["reads"] == (c["kReadTile"] if w.n_in + -(-w.hidden2 // 4) * 4 <= 47 else 1), w
        assert plan["f32_wide"] == (w.n_in + -(-w.hidden2 // 4) * 4 > 144
                                    or 4 * fik.f32_layout(w)["kWeights"] > fik.SHARED_LIMIT_BYTES), w
        for mode in ("f32x3", "bf16"):
            if plan[f"{mode}_wide"]:
                assert plan[f"{mode}_smem"] > fik.SHARED_LIMIT_BYTES or w.hidden1 > 256 or w.hidden2 > 64, w
            else:
                assert plan[f"{mode}_smem"] <= fik.SHARED_LIMIT_BYTES and w.hidden1 <= 256 and w.hidden2 <= 64, w
        assert plan["f32x3_stages"] % 2 == 0 and plan["bf16_stages"] % plan["bf16_consumers"] == 0
        for mode in ("f32", "f32x3", "bf16"):
            assert plan[f"{mode}_wide_smem"] <= fik.SHARED_LIMIT_BYTES, (w, mode)
        _covers(plan["f32_wide_unit_steps"], c["kWideChunk"], w.hidden1)
        h2_pad, tiles2 = -(-w.hidden2 // 4) * 4, -(-w.hidden2 // 8)
        pass_ = plan["f32_wide_pass"]
        assert pass_ == min(c["kWidePassCap"], max(16, 1 << (h2_pad - 1).bit_length())), w
        _covers(plan["f32_wide_passes"], pass_, h2_pad)
        _covers(plan["tc_wide_passes"], plan["tc_wide_pass_tiles"], tiles2)
        assert plan["tc_wide_pass_tiles"] == min(tiles2, t["kWidePassCap"]), w
        for mode, columns in (("f32", w.n_in + 1), ("f32x3", w.n_in + 1), ("bf16", -(-w.n_in // 16))):
            _covers(plan[f"{mode}_wide_in_steps"], plan[f"{mode}_wide_cols"], columns)
        assert plan["f32_wide_l1_threads"] == plan["f32_wide_threads"] >= plan["f32_wide_l2_threads"] >= 32, w
        assert plan["f32_wide_reads"] == c["kWideReads"] and plan["tc_wide_reads"] == 16 * t["kTcWideWarps"]


def _lane_groups(defines, work):
    """(kReads, kLaneGroup) that csrc/fused_infer.cu derives at each of
    ``defines`` (``-D`` macros; {} the released widths): its constants
    compiled for the host with g++, one namespace a set, in one program."""
    import subprocess

    f32 = _source_constants("fused_infer")
    parts, prints = ["#include <cstdint>\n#include <cstdio>\n"], []
    names = sorted({k for d in defines for k in d})
    for i, d in enumerate(defines):
        parts += [f"#undef {k}\n" for k in names]
        parts += [f"#define {k} {v}\n" for k, v in d.items()]
        parts.append(f"namespace f{i} {{\n{f32}}}\n")
        prints.append(f'  std::printf("%d %d\\n", f{i}::kReads, f{i}::kLaneGroup);')
    parts.append("int main() {\n" + "\n".join(prints) + "\n}\n")
    src, exe = os.path.join(work, "groups.cpp"), os.path.join(work, "groups")
    with open(src, "w") as f:
        f.write("".join(parts))
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", exe, src], check=True, capture_output=True)
    out = subprocess.run([exe], check=True, capture_output=True, text=True).stdout.split("\n")
    return [tuple(map(int, line.split())) for line in out[: len(defines)]]


def test_f32_phase_a_takes_lane_groups_where_a_read_keeps_few_values(tmp_path):
    """The f32 phase A shares h1 across groups of kLaneGroupTile lanes
    (G > 1) wherever it takes the plan of kReadTile reads a thread, a read
    keeps at most kLaneGroupValues values (its inputs and H2 to 4) and H2
    (to 4) splits into G lanes' float4s, and nowhere else: the signal-only
    model's tail (9 -> 150 -> 32, no k-mer input) and the production
    architecture at one position (5 inputs) take it; the released widths
    (47 values, and the production blocks' tail, 15 -> 150 -> 32) and every
    width of phases 21 and 23 do not; so over the grid of widths of the
    plan test, one position with H2 of 8 and 20 among them."""
    c = _build.cu_constants("fused_infer")
    g_tile = c["kLaneGroupTile"]
    assert g_tile > 1 and 32 % g_tile == 0 and c["kLaneGroupValues"] < 47
    tails = [encoder_kernel.tail_defines(encoder_kernel.TailWidths(n_in, 150, 32)) for n_in in (9, 15)]
    card = [fik.Widths(*w) for w in WIDTHS.values()] + [fik.Widths(1, 2, 150, 32)]
    grid = [fik.Widths(*w) for w in itertools.product((1, 3, 5, 11), (1, 4, 8), (1, 150, 256, 512),
                                                      (1, 8, 20, 32, 64, 128), (66, 1024))]
    widths = card + grid
    plans = _lane_groups([{}] + tails + [fik.kernel_defines(w, 1 if w.vocab <= 128 else 2) for w in widths],
                         str(tmp_path))
    assert plans[:3] == [(c["kReadTile"], 1), (c["kReadTile"], g_tile), (c["kReadTile"], 1)]
    assert [plan[1] for plan in plans[3 : 3 + len(card)]] == [1] * len(WIDTHS) + [g_tile]
    for w, (reads, group) in zip(widths, plans[3:]):
        h2_pad = -(-w.hidden2 // 4) * 4
        values = w.n_in + h2_pad
        takes = values <= c["kLaneGroupValues"] and h2_pad % (4 * g_tile) == 0
        assert (reads, group) == (c["kReadTile"] if values <= 47 else 1, g_tile if takes else 1), w


def _covers(steps, size, total):
    """``steps`` steps of ``size`` cover ``total`` with none past the last
    one needed."""
    assert steps * size >= total and (steps - 1) * size < total, (steps, size, total)


def test_kernel_limit_takes_what_it_took_before_the_wide_redesign():
    """kernel_limit passes exactly the widths it passed when the wide plans
    first ran (every width at least 1, at most 32,767 k-mers: the int16
    ids, at most 1,816 inputs a read) over a grid that crosses each edge,
    and refuses the rest naming the limit."""
    for widths in itertools.product((0, 1, 3, 11, 227, 229), (0, 1, 5, 8), (0, 1, 512, 4096), (0, 1, 128, 1000),
                                    (0, 1, 66, 32767, 32768)):
        w = fik.Widths(*widths)
        took = min(widths) >= 1 and w.vocab <= 32767 and w.n_in <= 1816
        limit = fik.kernel_limit(w)
        assert (limit is None) == took, (widths, limit)
        if min(widths) >= 1 and w.vocab > 32767:
            assert "int16 k-mer ids" in limit
        elif min(widths) >= 1 and w.n_in > 1816:
            assert "1816" in limit


def _write_long_runs(path, n_reads=30, n_pos=120):
    """Reads over long runs of consecutive positions, DRACH k-mers every 7
    (tests/test_dataprep.py's synthetic law): the demo's reads cover only 3
    positions around each site, so dataprep --n_neighbors 2 finds none
    there."""
    import random

    rng = random.Random(0)
    seq = "".join(rng.choice("ACGT") for _ in range(n_pos + 10))
    for i in range(5, n_pos, 7):
        seq = seq[:i] + "GGACT" + seq[i + 5 :]
    with open(os.path.join(os.path.dirname(__file__), "data", "eventalign.txt")) as f:
        header = f.readline()
    with open(path, "w") as f:
        f.write(header)
        for read in range(n_reads):
            for pos in range(n_pos):
                kmer = seq[pos : pos + 5]
                mean = 90 + (pos * 7 + read) % 40 + 0.25
                f.write(f"SYNTX.1\t{pos}\t{kmer}\t{read}\tt\t{pos}\t{mean}\t2.5\t0.004\t"
                        f"{kmer}\t100.0\t3.0\t0.5\t{pos * 10}\t{pos * 10 + 8}\n")


class _Sites:
    """A feed of seeded sites at ``positions`` k-mer positions, as either
    package's run_inference takes a dataset (``site_cls``: its Site)."""

    def __init__(self, site_cls, positions, n_sites=40, seed=0):
        rng = np.random.default_rng(seed)
        pad = "A" * ((positions - 1) // 2)
        self.sites = []
        for i in range(n_sites):
            n = int(rng.integers(20, 41))
            self.sites.append(site_cls(
                tx_id=f"SYN{i // 20}", tx_pos=10 * i, read_ids=np.arange(n, dtype=np.int64),
                features=rng.standard_normal(size=(n, 3 * positions), dtype=np.float32),
                kmer_ids=rng.integers(0, 66, size=positions).astype(np.int32), sequence=pad + "GGACT" + pad))
        self.max_site_reads = max(len(site.read_ids) for site in self.sites)

    def __len__(self):
        return len(self.sites)

    def iter_sites(self, n_threads=1):
        return iter(self.sites)


def test_two_neighbours_run_matches_the_jax_engine(width_models, tmp_path):
    """Five k-mer positions (dataprep --n_neighbors 2).  The port's dataprep
    finds the sites of reads over long runs; their outer 5-mers lie outside
    the 66 of the k-mer vocabulary, which both packages' datasets refuse
    alike.  Over seeded 5-position sites, the port's run_inference with a
    W1 model (--backend torch) against the JAX engine's: per read 1e-6,
    site 1e-5, mod_ratio equal off the threshold; and the CUDA backend's
    step on CPU tensors (its wrappers' plain versions) gives the modules'
    reads."""
    from m6anet_tpu.data.dataset import Site as JaxSite
    from m6anet_tpu_torch.data.dataset import Site

    source = str(tmp_path / "long_runs.txt")
    _write_long_runs(source)
    out = str(tmp_path / "dp")
    run_dataprep(source, out, n_processes=1, readcount_min=1, readcount_max=1000, min_segment_count=1,
                 n_neighbors=2, output_format="both")
    info = pd.read_csv(os.path.join(out, "data.info"))
    assert len(info) > 5 and (info.n_reads == 30).all()
    errors = []
    for build in (build_dataset, jax_build_dataset):
        with pytest.raises(KeyError) as raised:
            next(build(out, min_reads=20, norm_path=DEFAULT_NORM_PATH, num_neighboring_features=2).iter_sites())
        errors.append(str(raised.value))
    assert errors[0] == errors[1]

    jax_model, params, port = width_models["W1"]
    engine.run_inference(port, _Sites(Site, 5), str(tmp_path / "port"), THRESHOLD, backend="torch", device="cpu")
    jax_run_inference(jax_model, params, _Sites(JaxSite, 5), str(tmp_path / "jax"), read_proba_threshold=THRESHOLD,
                      backend="xla")
    feed = _Sites(Site, 5)
    gaps = compare_runs(str(tmp_path / "port"), str(tmp_path / "jax"), THRESHOLD, 1e-6, 1e-5)
    assert gaps["ok"] and gaps["rows"] == [sum(len(s.read_ids) for s in feed.sites), len(feed)], gaps
    step = engine.make_infer_step(port, 64, THRESHOLD, backend="cuda_fused", precision="f32")
    site = feed.sites[0]
    X = torch.from_numpy(site.features)
    K = torch.from_numpy(np.tile(site.kmer_ids, (X.shape[0], 1)))
    with torch.no_grad():
        p, *_ = step(X, K.to(torch.int8), torch.tensor([0], dtype=torch.int32),
                     torch.tensor([X.shape[0]], dtype=torch.int32))
        want = port.per_read_probability({"X": X, "kmer": K})
    torch.testing.assert_close(p, want, rtol=0, atol=1e-6)
