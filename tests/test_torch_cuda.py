"""Card-only tests of the port: the CUDA kernels and their entry points
against their plain versions, and the engine on the card against the engine
on the CPU.

They skip where no NVIDIA card is usable.  The file imports neither JAX nor
the JAX package, so on a machine without JAX run it without the suite's
conftest, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import json
import os
import tomllib

import numpy as np
import pytest
import torch

from m6anet_tpu_torch.constants import (
    DEFAULT_MIN_READS,
    DEFAULT_MODEL_CONFIG,
    DEFAULT_READ_THRESHOLD,
    PRETRAINED_CONFIGS,
)
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference.engine import run_inference
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.models.mil import MILModel
from m6anet_tpu_torch.ops import encoder_kernel, mc_kernel, random, site_ops
from m6anet_tpu_torch.ops import fused_infer_kernel as fik
from m6anet_tpu_torch.scripts._sweep import same_bits

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model():
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        return load_model(tomllib.load(f), PRETRAINED_CONFIGS["HCT116_RNA002"][0])


def _ragged_batch(seed=7, n=8192, s=512):
    """pack_sites layout: count-1 sites, long sites, padding reads, padding sites."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(n, 3)).astype(np.int8)
    offsets = np.zeros(s, np.int32)
    counts = np.zeros(s, np.int32)
    cursor = 0
    for i in range(s - 16):
        c = 1 if i % 9 == 0 else (700 if i == 3 else int(rng.integers(2, 40)))
        if cursor + c > n - 64:
            break
        offsets[i], counts[i] = cursor, c
        cursor += c
    return X, K, offsets, counts


def test_kernel_matches_plain(cuda_device):
    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    args = (X, K, None, offsets, counts, DEFAULT_READ_THRESHOLD)
    before = fik.launch_count
    got = fik.fused_inference_t(fp, *args)
    again = fik.fused_inference_t(fp, *args)
    want = fik.fused_inference_t_plain(fp, *args)
    torch.cuda.synchronize()
    assert fik.launch_count == before + 2
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    if not ((want[0] - DEFAULT_READ_THRESHOLD).abs() < 1e-6).any():
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # int32 k-mer ids are narrowed to int8 and take the same path
    got32 = fik.fused_inference_t(fp, X, K.int(), None, offsets, counts, DEFAULT_READ_THRESHOLD)
    assert all(torch.equal(a, b) for a, b in zip(got, got32))


def test_wrapper_checks_inputs(cuda_device):
    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    with pytest.raises(ValueError, match="features"):
        fik.fused_inference_t(fp, X.double(), K, None, offsets, counts, 0.5)
    with pytest.raises(ValueError, match="kmer_ids"):
        fik.fused_inference_t(fp, X, K.long(), None, offsets, counts, 0.5)
    with pytest.raises(ValueError, match="counts"):
        fik.fused_inference_t(fp, X, K, None, offsets, counts.cpu(), 0.5)
    with pytest.raises(ValueError, match="features"):
        fik.fused_inference_t(fp, X.t().contiguous().t(), K, None, offsets, counts, 0.5)
    bad = K.clone()
    bad[5, 2] = 66
    before = fik.launch_count, fik.site_reduce_launch_count
    with pytest.raises(ValueError, match="kmer_ids"):
        fik.fused_inference_t(fp, X, bad, None, offsets, counts, 0.5)
    with pytest.raises(ValueError, match="kmer_ids"):  # the host route raises before the call
        fik.fused_inference_t(fp, X, bad, None, offsets, counts, 0.5,
                              host_kmer_ids=fik.checked_kmer_ids(bad.cpu().numpy()))
    with pytest.raises(ValueError, match="host_kmer_ids have shape"):
        fik.fused_inference_t(fp, X, K, None, offsets, counts, 0.5,
                              host_kmer_ids=fik.checked_kmer_ids(K[1:].cpu().numpy()))
    assert (fik.launch_count, fik.site_reduce_launch_count) == before


def _dataset():
    norm = PRETRAINED_CONFIGS["HCT116_RNA002"][2]
    return build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")


def test_engine_on_the_card_matches_cpu_and_repeats_bit_for_bit(cuda_device, tmp_path):
    """The f32 kernel (asked for by name: the card's default is f32x3)
    against the CPU's f32 run."""
    thr = PRETRAINED_CONFIGS["HCT116_RNA002"][1]
    run_inference(_model(), _dataset(), str(tmp_path / "cpu"), thr, device="cpu")
    before = fik.launch_count, dict(fik.tc_launch_counts)
    run_inference(_model(), _dataset(), str(tmp_path / "a"), thr, precision="f32")  # default device: cuda
    assert (fik.launch_count, fik.tc_launch_counts) == (before[0] + 1, before[1])
    run_inference(_model(), _dataset(), str(tmp_path / "b"), thr, read_capacity=1024, site_capacity=8,
                  precision="f32")
    run_inference(_model(), _dataset(), str(tmp_path / "torch"), thr, backend="torch")
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        want = (tmp_path / "a" / name).read_bytes()
        assert (tmp_path / "b" / name).read_bytes() == want  # batching changes no byte
    for other in ("cpu", "torch"):
        for name, col, atol in (
            ("data.indiv_proba.csv", 3, 1e-6),
            ("data.site_proba.csv", 3, 1e-5),
        ):
            a = np.loadtxt(tmp_path / "a" / name, delimiter=",", skiprows=1, usecols=col)
            b = np.loadtxt(tmp_path / other / name, delimiter=",", skiprows=1, usecols=col)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_entry_points_match_plain(cuda_device):
    """fused_read_probability (phase A alone) and fused_inference (site ids
    given) against their plain versions, each counting its own launches."""
    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    before = encoder_kernel.launch_count, fik.fused_inference_launch_count, fik.launch_count
    p = encoder_kernel.fused_read_probability(fp, X, K)
    torch.testing.assert_close(p, encoder_kernel.fused_read_probability_plain(fp, X, K), rtol=0, atol=1e-6)
    full = fik.fused_inference_t(fp, X, K, None, offsets, counts, DEFAULT_READ_THRESHOLD)
    assert torch.equal(p, full[0])  # the same phase A
    site_ids = torch.full((X.shape[0],), counts.numel(), dtype=torch.int32, device=cuda_device)
    n_real = int(counts.sum())
    site_ids[:n_real] = torch.repeat_interleave(
        torch.arange(counts.numel(), device=cuda_device, dtype=torch.int32), counts.long())
    got = fik.fused_inference(fp, X, K, site_ids, counts, DEFAULT_READ_THRESHOLD)
    want = fik.fused_inference_plain(fp, X, K, site_ids, counts, DEFAULT_READ_THRESHOLD)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, full))  # offsets from the counts
    after = encoder_kernel.launch_count, fik.fused_inference_launch_count, fik.launch_count
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    with pytest.raises(ValueError, match="dense layout"):  # as on the CPU
        fik.fused_inference(fp, X, K, site_ids.flip(0).contiguous(), counts, DEFAULT_READ_THRESHOLD)
    assert fik.fused_inference_launch_count == after[1]


def test_ragged_tails_of_the_read_tile(cuda_device):
    """Read counts that end phase A's tile raggedly: every entry point
    against its plain version, and repeats bit for bit."""
    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    tile = fik.read_tile_reads()
    for batch in fik.ragged_tail_batches(tile):
        X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in batch)
        n = X.shape[0]
        args = (X, K, None, offsets, counts, DEFAULT_READ_THRESHOLD)
        got = fik.fused_inference_t(fp, *args)
        again = fik.fused_inference_t(fp, *args)
        want = fik.fused_inference_t_plain(fp, *args)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), n
        p = encoder_kernel.fused_read_probability(fp, X, K)
        assert torch.equal(p, got[0]), n
        site_ids = torch.full((n,), counts.numel(), dtype=torch.int32, device=cuda_device)
        site_ids[: int(counts.sum())] = torch.repeat_interleave(
            torch.arange(counts.numel(), device=cuda_device, dtype=torch.int32), counts.long())
        entry = fik.fused_inference(fp, X, K, site_ids, counts, DEFAULT_READ_THRESHOLD)
        assert all(torch.equal(a, b) for a, b in zip(entry, got)), n


def test_a_reads_p_does_not_depend_on_its_place(cuda_device):
    """p of batch[k:] is p[k:] of the whole batch, bit for bit: the tile
    couples no reads."""
    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    p = fik.fused_inference_t(fp, X, K, None, offsets, counts, DEFAULT_READ_THRESHOLD)[0]
    for k in (1, 3, 129):
        assert torch.equal(encoder_kernel.fused_read_probability(fp, X[k:], K[k:]), p[k:]), k


def _permute_sites(p, offsets, counts, order):
    """The batch with its sites in ``order`` (site i is old site order[i]),
    reads laid out again back to back, padding reads kept at the end."""
    parts, new_offsets, cursor = [], np.zeros_like(offsets), 0
    for i, s in enumerate(order):
        c = int(counts[s])
        parts.append(p[offsets[s] : offsets[s] + c])
        new_offsets[i] = cursor if c > 0 else 0
        cursor += c
    parts.append(p[cursor:])
    return np.concatenate(parts), new_offsets, counts[order]


def test_mc_kernel_matches_plain_and_repeats(cuda_device):
    """mc_kernel.ragged_mc_batch (a site at the cap, three of 25,000 reads in
    a row, counts 1-40 and around a bank's width, count-0 sites between real
    ones, a read with p = 1) at iteration counts below, at and above one
    thread's and one block's draws: the kernel within 1e-6 of the plain
    version, repeats and a reordering of the sites bit for bit."""
    p, offsets, counts = mc_kernel.ragged_mc_batch()
    order = np.roll(np.arange(len(counts)), 37)
    moved = _permute_sites(p, offsets, counts, order)
    p, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in (p, offsets, counts))
    moved = [torch.from_numpy(a).to(cuda_device) for a in moved]
    for n_iters in (1, 255, 257, 1000, 1500, 2000):
        u = torch.from_numpy(random.shared_draws(3, n_iters)).to(cuda_device)
        before = mc_kernel.launch_count
        got = mc_kernel.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
        again = mc_kernel.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
        elsewhere = mc_kernel.site_probability_mc_cuda(*moved, u, n_iters)
        want = mc_kernel.site_probability_mc_plain(p, offsets, counts, u, n_iters)
        torch.cuda.synchronize()
        assert mc_kernel.launch_count == before + 3
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert torch.equal(got, again), n_iters
        assert torch.equal(elsewhere, got[torch.from_numpy(order).to(cuda_device)]), n_iters
        assert bool((got[counts == 0] == 0).all()) and bool(torch.isfinite(got).all())
    # a count past the draw index's range, or a span outside p, raises on
    # both routes of the check
    top = mc_kernel.MAX_SITE_READS
    big = torch.tensor([top + 1], dtype=torch.int32, device=cuda_device)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    host = (np.zeros(1, np.int32), np.array([top + 1], np.int32))
    for host_sites in (None, host):  # the device check and the host check
        with pytest.raises(ValueError, match=f"above the {top}"):
            mc_kernel.site_probability_mc_cuda(
                torch.rand(64, device=cuda_device), zero, big, u, 2000, host_sites=host_sites)
        cap = mc_kernel.MAX_STAGED_READS
        with pytest.raises(ValueError, match="reach outside p"):
            mc_kernel.site_probability_mc_cuda(
                torch.rand(cap, device=cuda_device), zero + 1, zero + cap, u, 2000,
                host_sites=None if host_sites is None else (host[0] + 1, host[1] * 0 + cap))
    with pytest.raises(ValueError, match="u has shape"):
        mc_kernel.site_probability_mc_cuda(p, offsets, counts, u[:, :100], 2000)
    # another number of draws an iteration builds its own kernel
    u7 = torch.from_numpy(random.shared_draws(3, 2000, 7)).to(cuda_device)
    got = mc_kernel.site_probability_mc_cuda(p, offsets, counts, u7, 2000, 7)
    torch.testing.assert_close(got, mc_kernel.site_probability_mc_plain(p, offsets, counts, u7, 2000, 7),
                               rtol=0, atol=1e-6)


def _mc_through_long_kernel(p, offsets, counts, u, n_iters):
    """site_p with every site of 1 read or more through mc_long_site_kernel:
    mc.cu's staged launch sized for count 0 (NaN at those sites), then its
    long-site launch from count 0 over every such site.  No launch is
    counted."""
    lib = mc_kernel.kernel_lib()
    n_sites = counts.shape[0]
    site_p = torch.empty(n_sites, dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    assert lib.cdll.mc_site_launch(p.data_ptr(), offsets.data_ptr(), counts.data_ptr(), u.data_ptr(),
                                   site_p.data_ptr(), n_sites, p.shape[0], n_iters, mc_kernel.SAMPLES, 0, stream) == 0
    mc_kernel.launch_long_sites(lib, p, offsets, counts, u, site_p, mc_kernel.long_sites(counts, 0), n_iters,
                                mc_kernel.SAMPLES, 0)
    return site_p


def test_mc_long_sites_on_the_card(cuda_device):
    """Sites of 57,345, 100,000 and 1,000,000 reads beside the ragged
    batch's (mc_kernel.ragged_mc_batch(long_sites=True)) at T = 1000 and
    4097 (past 16 blocks of 256 iterations): within 1e-6 of the plain
    version; every other site the same bits as without them; every site
    sent through the long-site kernel the same bits as the staged kernel
    gives; one launch of each kernel a call.  18 sites of 57,345 reads
    (all long): within 1e-6 of the plain version, the device list's and
    the host list's bits the same, repeats bit-identical, one scratch
    for two launches (its tickets left zero) and 128 draws an iteration
    within 1e-6 of the plain version."""
    p, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in mc_kernel.ragged_mc_batch(long_sites=True))
    p0, off0, cnt0 = (torch.from_numpy(a).to(cuda_device) for a in mc_kernel.ragged_mc_batch())
    keep = torch.cat([torch.arange(len(cnt0) - 16), torch.arange(len(counts) - 16, len(counts))]).to(cuda_device)
    for n_iters in (1000, 4097):
        u = torch.from_numpy(random.shared_draws(5, n_iters)).to(cuda_device)
        before = mc_kernel.launch_count, mc_kernel.long_launch_count
        got = mc_kernel.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
        assert (mc_kernel.launch_count, mc_kernel.long_launch_count) == (before[0] + 1, before[1] + 1)
        alone = mc_kernel.site_probability_mc_cuda(p0, off0, cnt0, u, n_iters)
        through_long = _mc_through_long_kernel(p, offsets, counts, u, n_iters)
        want = mc_kernel.site_probability_mc_plain(p, offsets, counts, u, n_iters)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert same_bits(got[keep], alone) and same_bits(through_long, got), n_iters
        assert bool(torch.isfinite(got).all()) and bool((got[counts > mc_kernel.MAX_STAGED_READS] > 0).all())
    rng = np.random.default_rng(8)
    counts = np.full(18, mc_kernel.MAX_STAGED_READS + 1, np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    p = rng.uniform(0.0, 0.3, size=int(counts.sum())).astype(np.float32)
    t = [torch.from_numpy(a).to(cuda_device) for a in (p, offsets, counts)]
    u = torch.from_numpy(random.shared_draws(5, 1000)).to(cuda_device)
    got = mc_kernel.site_probability_mc_cuda(*t, u, 1000, host_sites=(offsets, counts))
    again = mc_kernel.site_probability_mc_cuda(*t, u, 1000)
    want = mc_kernel.site_probability_mc_plain(*t, u, 1000)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(got, again) and bool(torch.isfinite(got).all())
    # one scratch for two launches: the kernel leaves its tickets zero
    lib, listed = mc_kernel.kernel_lib(), mc_kernel.long_sites(t[2])
    scratch = mc_kernel.long_scratch(len(counts), 1000, cuda_device)
    for _ in range(2):
        out = torch.full_like(got, float("nan"))
        mc_kernel.launch_long_sites(lib, *t, u, out, listed, 1000, mc_kernel.SAMPLES, mc_kernel.MAX_STAGED_READS,
                                    scratch)
        assert same_bits(out, got) and int(torch.count_nonzero(scratch[1])) == 0
    # 128 draws an iteration, which the long kernel issues in rounds
    u128 = torch.from_numpy(random.shared_draws(5, 300, 128)).to(cuda_device)
    got = mc_kernel.site_probability_mc_cuda(*t, u128, 300, 128, host_sites=(offsets, counts))
    torch.testing.assert_close(got, mc_kernel.site_probability_mc_plain(*t, u128, 300, 128), rtol=0, atol=1e-6)


@pytest.mark.parametrize("precision", ["f32", "f32x3", "bf16"])
@pytest.mark.parametrize("widths", [(3, 3, 100, 20), (11, 4, 96, 24), (11, 4, 256, 64), (1, 4, 256, 64)])
def test_kernels_at_other_widths_match_plain(cuda_device, widths, precision):
    """The production architecture at other widths (seeded weights, their
    own libraries built at first use): fused_inference_t against its plain
    version at chip_smoke.py's phase 12 tolerances, repeats bit-identical,
    and phase A alone the same p."""
    from m6anet_tpu_torch.models.mil import MILModel

    model = MILModel(fik.widths_config(fik.Widths(*widths))).init(torch.Generator().manual_seed(3))
    fp = fik.prepare_fused_params_t(model.eval().to(cuda_device))
    rng = np.random.default_rng(9)
    n, positions = 8192, widths[0]
    X = torch.from_numpy(rng.normal(size=(n, 3 * positions)).astype(np.float32)).to(cuda_device)
    K = torch.from_numpy(rng.integers(0, 66, size=(n, positions)).astype(np.int8)).to(cuda_device)
    counts = torch.from_numpy(rng.integers(1, 40, size=300).astype(np.int32)).to(cuda_device)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    args = (X, K, None, offsets, counts, 0.5, 20, precision)
    got = fik.fused_inference_t(fp, *args)
    again = fik.fused_inference_t(fp, *args)
    want = fik.fused_inference_t_plain(fp, *args)
    alone = encoder_kernel.fused_read_probability(fp, X, K, precision)
    torch.cuda.synchronize()
    atol = {"f32": 1e-6, "f32x3": 2e-6, "bf16": 1e-3}[precision]
    err = float((got[0] - want[0]).abs().max())
    assert err <= atol
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5 + 20 * err)
    assert all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(alone, got[0])


def test_mc_kernel_gives_nan_for_sites_the_launch_cannot_take(cuda_device):
    """host_sites that are not the source of the tensors on the card: a site
    longer than the launch was sized for, or whose span leaves p, gives NaN
    with no fault, and every other site keeps its value bit for bit."""
    rng = np.random.default_rng(21)
    counts = np.full(40, 10, np.int32)
    counts[7] = 50
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    p = rng.uniform(0.0, 0.3, size=int(counts.sum())).astype(np.float32)
    host_counts = counts.copy()
    host_counts[7] = 10  # the launch is sized for 10 reads a site
    moved = offsets.copy()
    moved[3] = len(p) - 5  # on the card, site 3's span leaves p
    def t(a):
        return torch.from_numpy(a).to(cuda_device)

    u = t(random.shared_draws(6, 1000))
    got = mc_kernel.site_probability_mc_cuda(t(p), t(moved), t(counts), u, 1000, host_sites=(offsets, host_counts))
    want = mc_kernel.site_probability_mc_cuda(t(p), t(offsets), t(counts), u, 1000, host_sites=(offsets, counts))
    torch.cuda.synchronize()
    bad = torch.zeros(40, dtype=torch.bool, device=cuda_device)
    bad[[3, 7]] = True
    assert bool(got[bad].isnan().all())
    assert torch.equal(got[~bad], want[~bad])


@pytest.mark.parametrize("precision", ["f32", "f32x3", "bf16"])
def test_phase_b_gives_nan_for_sites_whose_span_leaves_p(cuda_device, precision):
    """offsets and counts that put a site's span outside p (a negative
    offset, a negative count, a span past the last read): that site's
    site_p and mod_ratio are NaN, with no load outside p, and every other
    output keeps its value bit for bit."""
    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    n = X.shape[0]
    args = (DEFAULT_READ_THRESHOLD, 20, precision)
    want = fik.fused_inference_t(fp, X, K, None, offsets, counts, *args)
    bad_offsets, bad_counts = offsets.clone(), counts.clone()
    bad_offsets[4] = -3
    bad_counts[9] = -1
    bad_offsets[20], bad_counts[20] = n - 2, 3
    got = fik.fused_inference_t(fp, X, K, None, bad_offsets, bad_counts, *args)
    torch.cuda.synchronize()
    bad = torch.zeros(counts.numel(), dtype=torch.bool, device=cuda_device)
    bad[[4, 9, 20]] = True
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert bool(a[bad].isnan().all()) and not bool(b[bad].isnan().any())
        assert torch.equal(a[~bad], b[~bad])


@pytest.mark.parametrize("precision", ["f32", "f32x3", "bf16"])
def test_phase_b_is_bit_identical_to_the_plain_site_ops(cuda_device, precision):
    """Phase B's exact integer sums: on the kernel's own p of each precision
    (the production batch and a ragged batch) site_p and mod_ratio are the
    same bits as the plain site ops give on that p, and so is phase B alone
    on that p with three reads made NaN (phase A makes no NaN: its ReLU
    drops one) and on site_reduce_batch (p at the edges of the sums, NaN
    reads, counts 0 to 57,344), twice over."""
    from m6anet_tpu_torch.scripts._sweep import production_batch

    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    for batch in (production_batch(), _ragged_batch()):
        X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in batch)
        before = fik.site_reduce_launch_count
        p, site_p, mod_ratio = fik.fused_inference_t(fp, X, K, None, offsets, counts, DEFAULT_READ_THRESHOLD, 20,
                                                     precision)
        assert fik.site_reduce_launch_count == before + 1
        want = fik.site_reduce_plain(p, offsets, counts, DEFAULT_READ_THRESHOLD)
        assert same_bits(site_p, want[0]) and same_bits(mod_ratio, want[1])
        p[[0, 1500, 4000]] = float("nan")
        got = fik.site_reduce(p, offsets, counts, DEFAULT_READ_THRESHOLD)
        want = fik.site_reduce_plain(p, offsets, counts, DEFAULT_READ_THRESHOLD)
        assert bool(got[0].isnan().any())
        assert all(same_bits(a, b) for a, b in zip(got, want))
    p, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in fik.site_reduce_batch())
    for n_samples in (20, 1, 0):
        got = fik.site_reduce(p, offsets, counts, DEFAULT_READ_THRESHOLD, n_samples)
        again = fik.site_reduce(p, offsets, counts, DEFAULT_READ_THRESHOLD, n_samples)
        want = fik.site_reduce_plain(p, offsets, counts, DEFAULT_READ_THRESHOLD, n_samples)
        assert all(same_bits(a, b) for a, b in zip(got, want)), n_samples
        assert all(same_bits(a, b) for a, b in zip(got, again)), n_samples


def test_phase_b_outside_its_domain(cuda_device):
    """A read outside [0, 1] (phase A makes none) makes its site's site_p
    NaN, and 0 with n_samples = 0 (1 - NaN ** 0); mod_ratio counts it as
    p >= threshold says; every other site keeps the plain version's bits."""
    counts = np.array([10, 10, 10, 10, 10, 0], np.int32)
    offsets = np.array([0, 10, 20, 30, 40, 0], np.int32)
    p = np.random.default_rng(8).uniform(0, 1, size=53).astype(np.float32)
    p[[3, 15, 27, 38]] = [1.5, -0.25, np.inf, -np.inf]
    t = [torch.from_numpy(a).to(cuda_device) for a in (p, offsets, counts)]
    bad = torch.tensor([True, True, True, True, False, False], device=cuda_device)
    for n_samples in (20, 0):
        site_p, mod_ratio = fik.site_reduce(*t, DEFAULT_READ_THRESHOLD, n_samples)
        want = fik.site_reduce_plain(*t, DEFAULT_READ_THRESHOLD, n_samples)
        if n_samples:
            assert bool(site_p[bad].isnan().all())
        else:
            assert bool((site_p[bad] == 0).all())
        assert same_bits(site_p[~bad], want[0][~bad]) and same_bits(mod_ratio, want[1])


@pytest.mark.parametrize("precision", ["f32", "f32x3", "bf16"])
def test_engine_exact_step_makes_no_host_sync(cuda_device, precision):
    """The engine's exact cuda_fused step, given the batch's host k-mer ids
    as the engine's pack thread checks them, launches both phases with no
    device-to-host sync: under set_sync_debug_mode("error") it runs, while
    the same step checking the ids on the device raises."""
    from m6anet_tpu_torch.inference import engine

    model = _model().to(cuda_device).eval()
    X, K, offsets, counts = _ragged_batch()
    step = engine.make_infer_step(model, len(counts), DEFAULT_READ_THRESHOLD, 20, "exact", "cuda_fused",
                                  precision=precision)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X, K, offsets, counts)]
    host = dict(host_sites=(offsets, counts), host_kmer_ids=fik.checked_kmer_ids(K))
    with torch.no_grad():
        want = step(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = step(*args, **host)
            with pytest.raises(RuntimeError, match="synchroniz"):
                step(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_encoder_call_of_the_cuda_backend_makes_no_host_sync(cuda_device, monkeypatch):
    """The cuda backend's step hands fused_read_probability the batch's
    host k-mer ids: the encoder call makes no host sync, in every
    precision."""
    from m6anet_tpu_torch.inference import engine

    real = encoder_kernel.fused_read_probability
    seen = []

    def no_sync(*args, **kwargs):
        seen.append(kwargs.get("host_kmer_ids") is not None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(encoder_kernel, "fused_read_probability", no_sync)
    model = _model().to(cuda_device).eval()
    fp = fik.prepare_fused_params_t(model)
    X, K, offsets, counts = _ragged_batch()
    args = [torch.from_numpy(a).to(cuda_device) for a in (X, K, offsets, counts)]
    with torch.no_grad():
        for precision in ("f32", "f32x3", "bf16"):
            step = engine.make_infer_step(model, len(counts), DEFAULT_READ_THRESHOLD, 20, "exact", "cuda",
                                          precision=precision)
            got = step(*args, host_sites=(offsets, counts), host_kmer_ids=fik.checked_kmer_ids(K))
            with pytest.raises(RuntimeError, match="synchroniz"):
                step(*args)
            want = real(fp, *args[:2], precision)
            assert torch.equal(got[0], want), precision
    assert seen == [True, False] * 3


def test_engine_mc_step_makes_no_host_sync(cuda_device, monkeypatch):
    """The engine's MC step hands the MC wrapper the batch's host offsets
    and counts, so the wrapper checks them without a device-to-host sync:
    under set_sync_debug_mode("error") any sync inside it raises, as it does
    for the check on the device tensors."""
    from m6anet_tpu_torch.inference import engine

    real = mc_kernel.site_probability_mc_cuda
    seen = []

    def no_sync(*args, **kwargs):
        seen.append(kwargs.get("host_sites") is not None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(mc_kernel, "site_probability_mc_cuda", no_sync)
    model = _model().to(cuda_device).eval()
    X, K, offsets, counts = _ragged_batch()
    step = engine.make_infer_step(model, len(counts), DEFAULT_READ_THRESHOLD, 20, "mc", "cuda_fused",
                                  n_iterations=1000, seed=2)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X, K, offsets, counts)]
    before = mc_kernel.launch_count
    with torch.no_grad():
        got = step(*args, host_sites=(offsets, counts))[1]
        with pytest.raises(RuntimeError, match="synchroniz"):
            step(*args)
        monkeypatch.undo()
        want = step(*args)[1]
    assert seen == [True, False] and mc_kernel.launch_count == before + 2
    assert torch.equal(got, want)


def test_engine_mc_step_with_a_long_site_makes_no_host_sync(cuda_device, monkeypatch):
    """A batch whose site of MAX_STAGED_READS + 1 reads takes the
    long-site kernel: with the batch's host offsets and counts the MC
    wrapper lists that site on the host and copies the list through pinned
    memory, so under set_sync_debug_mode("error") it makes no host sync;
    one launch of each MC kernel, and the same site_p as the wrapper
    checking the tensors on the card."""
    from m6anet_tpu_torch.inference import engine

    real = mc_kernel.site_probability_mc_cuda

    def no_sync(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    model = _model().to(cuda_device).eval()
    rng = np.random.default_rng(4)
    counts = np.array([30, mc_kernel.MAX_STAGED_READS + 1, 7, 0], np.int32)
    offsets = np.array([0, 30, 30 + counts[1], 0], np.int32)
    n = int(counts.sum()) + 64
    X = rng.normal(size=(n, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(n, 3)).astype(np.int8)
    step = engine.make_infer_step(model, len(counts), DEFAULT_READ_THRESHOLD, 20, "mc", "cuda_fused",
                                  n_iterations=1000, seed=2)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X, K, offsets, counts)]
    before = mc_kernel.launch_count, mc_kernel.long_launch_count
    with torch.no_grad():
        monkeypatch.setattr(mc_kernel, "site_probability_mc_cuda", no_sync)
        got = step(*args, host_sites=(offsets, counts))[1]
        monkeypatch.undo()
        want = step(*args)[1]
    torch.cuda.synchronize()
    assert (mc_kernel.launch_count, mc_kernel.long_launch_count) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all()) and float(got[3]) == 0.0


def test_engine_mc_and_encoder_backend_on_the_card(cuda_device, tmp_path):
    """MC through the MC kernel: repeats and rebatching give the same bytes;
    the cuda backend (encoder kernel + order-free site statistics) repeats
    bit for bit and agrees with the fused kernel."""
    thr = PRETRAINED_CONFIGS["HCT116_RNA002"][1]
    mc = dict(method="mc", num_iterations=500, seed=4)
    before = mc_kernel.launch_count
    run_inference(_model(), _dataset(), str(tmp_path / "mc_a"), thr, **mc)
    assert mc_kernel.launch_count == before + 1
    run_inference(_model(), _dataset(), str(tmp_path / "mc_b"), thr, read_capacity=1024, site_capacity=8, **mc)
    before = mc_kernel.launch_count, encoder_kernel.launch_count
    run_inference(_model(), _dataset(), str(tmp_path / "mc_cuda"), thr, backend="cuda", **mc)
    assert (mc_kernel.launch_count, encoder_kernel.launch_count) == (before[0] + 1, before[1] + 1)
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        want = (tmp_path / "mc_a" / name).read_bytes()
        assert (tmp_path / "mc_b" / name).read_bytes() == want
    a = np.loadtxt(tmp_path / "mc_a" / "data.site_proba.csv", delimiter=",", skiprows=1, usecols=3)
    b = np.loadtxt(tmp_path / "mc_cuda" / "data.site_proba.csv", delimiter=",", skiprows=1, usecols=3)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

    before = encoder_kernel.launch_count
    run_inference(_model(), _dataset(), str(tmp_path / "enc_a"), thr, backend="cuda")
    assert encoder_kernel.launch_count == before + 1
    run_inference(_model(), _dataset(), str(tmp_path / "enc_b"), thr, backend="cuda")
    run_inference(_model(), _dataset(), str(tmp_path / "fused"), thr)
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (tmp_path / "enc_a" / name).read_bytes() == (tmp_path / "enc_b" / name).read_bytes()
    for name, atol in (("data.indiv_proba.csv", 0), ("data.site_proba.csv", 1e-5)):
        a = np.loadtxt(tmp_path / "enc_a" / name, delimiter=",", skiprows=1, usecols=3)
        b = np.loadtxt(tmp_path / "fused" / name, delimiter=",", skiprows=1, usecols=3)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _assert_mode_close(got, want, mode, tally):
    """Kernel vs plain per read (chip_smoke.py's P_ATOL and CLOSE_SHARE):
    every read within 2e-6 (f32x3: the tensor cores round inside a k16 sum
    in their own way) or 1e-3 (bf16: an f32 sum that differs in its last
    bit can round an activation to the neighbouring bf16 value); the reads
    more than 1e-6 apart are counted in ``tally`` for a share over the
    whole test."""
    err = (got - want).abs()
    assert float(err.max()) <= {"f32x3": 2e-6, "bf16": 1e-3}[mode], float(err.max())
    tally[0] += err.numel()
    tally[1] += int((err > 1e-6).sum())


@pytest.mark.parametrize("mode", ["f32x3", "bf16"])
def test_reduced_modes_match_plain(cuda_device, mode):
    """The tensor-core phase A and phase B of fused_infer.cu against the
    plain version of the mode: a ragged batch, the ragged tails of the
    tensor-core block, shifted placements bit for bit, int32 ids, repeats
    bit for bit, and the two other entry points on the same kernel."""
    fp = fik.prepare_fused_params_t(_model().to(cuda_device))
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    args = (X, K, None, offsets, counts, DEFAULT_READ_THRESHOLD, 20, mode)
    before = fik.launch_count, fik.tc_launch_counts[mode]
    got = fik.fused_inference_t(fp, *args)
    again = fik.fused_inference_t(fp, *args)
    want = fik.fused_inference_t_plain(fp, *args)
    torch.cuda.synchronize()
    assert (fik.launch_count, fik.tc_launch_counts[mode]) == (before[0] + 2, before[1] + 2)
    tally = [0, 0]
    _assert_mode_close(got[0], want[0], mode, tally)
    # site_p 1e-5, and 20 max|dp| more at a site holding a read further
    # than 1e-6 apart (the derivative of 1 - m**20 is at most 20)
    far = torch.zeros(counts.numel() + 1, device=cuda_device).index_add_(
        0, site_ops.derive_site_ids(offsets, counts, X.shape[0], counts.numel()).long(),
        ((got[0] - want[0]).abs() > 1e-6).float())[:-1]
    allowed = 1e-5 + 20 * (got[0] - want[0]).abs().max() * (far > 0)
    assert bool(((got[1] - want[1]).abs() <= allowed).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    got32 = fik.fused_inference_t(fp, X, K.int(), *args[2:])
    assert all(torch.equal(a, b) for a, b in zip(got, got32))
    for k in (1, 3, 70, 129):  # 70 moves reads across a 64-read tile
        assert torch.equal(encoder_kernel.fused_read_probability(fp, X[k:], K[k:], mode), got[0][k:]), k
    for batch in fik.ragged_tail_batches(fik.read_tile_reads(mode)):
        Xt, Kt, ot, ct = (torch.from_numpy(a).to(cuda_device) for a in batch)
        targs = (Xt, Kt, None, ot, ct, DEFAULT_READ_THRESHOLD, 20, mode)
        tail = fik.fused_inference_t(fp, *targs)
        _assert_mode_close(tail[0], fik.fused_inference_t_plain(fp, *targs)[0], mode, tally)
        assert torch.equal(encoder_kernel.fused_read_probability(fp, Xt, Kt, mode), tail[0])
        site_ids = torch.full((Xt.shape[0],), ct.numel(), dtype=torch.int32, device=cuda_device)
        site_ids[: int(ct.sum())] = torch.repeat_interleave(
            torch.arange(ct.numel(), device=cuda_device, dtype=torch.int32), ct.long())
        entry = fik.fused_inference(fp, Xt, Kt, site_ids, ct, DEFAULT_READ_THRESHOLD, precision=mode)
        assert all(torch.equal(a, b) for a, b in zip(entry, tail))
    assert tally[1] <= {"f32x3": 1e-5, "bf16": 1e-3}[mode] * tally[0] + 1, tally


def test_engine_precisions_on_the_card(cuda_device, tmp_path):
    """auto is f32x3 on the card: each run reports its own kernel, f32x3
    stays within 1e-5 of f32 per read and repeats bit for bit at another
    batching; bf16 stays within 2e-2 per read and 1e-2 per site."""
    thr = PRETRAINED_CONFIGS["HCT116_RNA002"][1]
    runs = {}
    for name, kw in (("auto", {}), ("small", dict(read_capacity=1024, site_capacity=8)),
                     ("f32", dict(precision="f32")), ("bf16", dict(precision="bf16"))):
        before = dict(fik.tc_launch_counts)
        run_inference(_model(), _dataset(), str(tmp_path / name), thr, **kw)
        mode = kw.get("precision", "f32x3")
        if mode != "f32":
            assert fik.tc_launch_counts[mode] > before[mode]
        runs[name] = [np.loadtxt(tmp_path / name / f, delimiter=",", skiprows=1, usecols=3)
                      for f in ("data.indiv_proba.csv", "data.site_proba.csv")]
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        assert (tmp_path / "small" / name).read_bytes() == (tmp_path / "auto" / name).read_bytes()
    np.testing.assert_allclose(runs["auto"][0], runs["f32"][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(runs["bf16"][0], runs["f32"][0], rtol=0, atol=2e-2)
    np.testing.assert_allclose(runs["bf16"][1], runs["f32"][1], rtol=0, atol=1e-2)


# ---------------------------------------------------------------- training
TRAIN_LR = 4e-3


def _train_batches(n, sites=256, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "X": rng.normal(size=(sites, 20, 9)).astype(np.float32),
        "kmer": rng.integers(0, 66, size=(sites, 20, 3)).astype(np.int32),
        "y": rng.integers(0, 2, size=sites).astype(np.float32),
    } for _ in range(n)]


def _train_steps(state, device, batches):
    from m6anet_tpu_torch.models.convert import params_to_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.train import loop, losses

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        model = MILModel(tomllib.load(f)).to(device)
    model.load_state_dict(state)
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss,
                                loop.make_optimizer(model, TRAIN_LR, 1e-5), 5.0)
    out = torch.stack([step(loop.batch_to_device(b, torch.device(device)))[0] for b in batches])
    return out.cpu().numpy(), params_to_jax(model.state_dict())


def test_train_steps_on_the_card_match_cpu(cuda_device):
    """From the released weights, on 256 x 20 batches: the first step
    within 1e-6 of the CPU's (loss relative; every parameter, but 2 lr
    where the CPU's gradient is below 1e-6: Adam's first step turns f32
    noise there into steps of order lr), and five steps each side within
    1e-3 relative (losses) and 2 lr (parameters), as chip_smoke.py phase
    14 holds twenty (PERF.md, "Training")."""
    from m6anet_tpu_torch.models.convert import params_from_jax, params_to_jax
    from m6anet_tpu_torch.train import losses
    from m6anet_tpu_torch.utils.treeio import load_tree

    state = params_from_jax(load_tree(PRETRAINED_CONFIGS["HCT116_RNA002"][0]))
    batches = _train_batches(5)
    grad_model = _model()
    grad_model.load_state_dict(state)
    first = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    losses.binary_cross_entropy_loss(grad_model.site_probability(first, train=True), first["y"]).backward()
    grads = params_to_jax({k: p.grad for k, p in grad_model.named_parameters()})
    (card_loss,), card = _train_steps(state, "cuda", batches[:1])
    (cpu_loss,), cpu = _train_steps(state, "cpu", batches[:1])
    assert abs(card_loss - cpu_loss) <= 1e-6 * abs(cpu_loss)
    for blk in cpu:
        for leaf, want in cpu[blk].items():
            loose = np.abs(grads[blk][leaf]) < 1e-6 if leaf in grads[blk] else np.zeros(want.shape, bool)
            np.testing.assert_allclose(card[blk][leaf][~loose], want[~loose], rtol=0, atol=1e-6, err_msg=leaf)
            np.testing.assert_allclose(card[blk][leaf][loose], want[loose], rtol=0, atol=2 * TRAIN_LR, err_msg=leaf)
    card_losses, card = _train_steps(state, "cuda", batches)
    cpu_losses, cpu = _train_steps(state, "cpu", batches)
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-3)
    for blk in cpu:
        for leaf, want in cpu[blk].items():
            np.testing.assert_allclose(card[blk][leaf], want, rtol=0, atol=2 * TRAIN_LR, err_msg=leaf)


@pytest.mark.parametrize("loss_name", ["binary_cross_entropy_loss", "weighted_binary_cross_entropy_loss"])
def test_epoch_steps_make_no_host_sync(cuda_device, loss_name):
    """An epoch's train steps, numpy batches in (a wrap-padded last batch
    among them), and the eval steps launch with no device-to-host sync:
    the loop fetches once per epoch."""
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.train import loop, losses

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        model = MILModel(tomllib.load(f)).init(torch.Generator().manual_seed(0)).to(cuda_device)
    loss_fn = losses.LOSS_REGISTRY[loss_name]
    step = loop.make_train_step(model, loss_fn, loop.make_optimizer(model, TRAIN_LR, 1e-5), 5.0)
    eval_step = loop.make_eval_step(model, loss_fn)
    batches = [dict(b, n_valid=64) for b in _train_batches(4, sites=64)]
    batches[-1]["n_valid"] = 40  # rows 40-63 are wrap-around padding
    generator = torch.Generator(device=cuda_device)
    loop.run_epoch_steps(step, batches[:1], generator, cuda_device)  # first-use set-up syncs
    eval_step(loop.batch_to_device(_train_batches(1, sites=64)[0], cuda_device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_losses, pred_parts, y_true = loop.run_epoch_steps(step, batches, generator, cuda_device)
        preds = [eval_step(loop.batch_to_device({k: b[k] for k in ("X", "kmer", "y")}, cuda_device))[1]
                 for b in batches]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got_losses, got_preds = loop._fetch(step_losses, pred_parts)
    assert got_losses.shape == (4,) and np.isfinite(got_losses).all()
    assert got_preds.shape == (3 * 64 + 40,) == np.concatenate(y_true).shape
    assert all(torch.isfinite(p).all() for p in preds)


def test_train_cli_on_the_card_writes_the_jax_layout(cuda_device, tmp_path):
    from m6anet_tpu_torch.cli import main
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH, TRAIN_CONFIG_TEMPLATE
    from m6anet_tpu_torch.utils.config import dump_toml, load_toml
    from m6anet_tpu_torch.utils.treeio import load_tree

    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=DATA_DIR, norm_path=DEFAULT_NORM_PATH)
    dump_toml(cfg, str(tmp_path / "train.toml"))
    out = tmp_path / "out"
    main(["train", "--train_config", str(tmp_path / "train.toml"), "--save_dir", str(out), "--epochs", "2",
          "--save_per_epoch", "2", "--num_iterations", "1"])  # the default device: the card
    assert sorted(os.listdir(out / "model_states" / "2")) == ["meta.json", "model_states.npz", "opt_state.npz"]
    with np.load(out / "model_states" / "2" / "opt_state.npz") as data:
        assert len(data.files) == 23 and data["leaf_0000"].dtype == np.int32
    for name in ("avg_loss.npz", "roc_auc.npz", "pr_auc.npz"):
        tree = load_tree(str(out / name))
        assert sorted(f"{b}/{leaf}" for b in tree for leaf in tree[b]) == [
            "block1/embedding", "block3/b", "block3/bn_bias", "block3/bn_mean", "block3/bn_scale", "block3/bn_var",
            "block3/w", "block4/b", "block4/w", "block5/b", "block5/w"]
        assert tree["block3"]["w"].shape == (15, 150)
    for name in ("train_results.json", "val_results.json", "test_results_avg_loss.json"):
        with open(out / name) as f:
            assert np.isfinite(json.load(f)["avg_loss"]).all()


# ------------------------------------------------- released models, generic
def _assert_runs_close(got_dir, want_dir, threshold, read_atol, site_atol=1e-5):
    """inference.outputs.compare_runs on the demo's outputs (5,595 reads,
    101 sites)."""
    from m6anet_tpu_torch.inference.outputs import compare_runs

    gaps = compare_runs(str(got_dir), str(want_dir), threshold, read_atol, site_atol)
    assert gaps["ok"] and gaps["rows"] == [5595, 101], gaps


@pytest.mark.parametrize("name", sorted(PRETRAINED_CONFIGS))
def test_released_models_match_the_torch_backend_on_the_card(cuda_device, tmp_path, name):
    """Each released model (its own weights, threshold and norm factors)
    through cuda_fused at f32 and f32x3 against --backend torch on the card:
    per read within 1e-6 (f32) and 2e-5 (f32x3), or twice the mode's own
    error against an f64 copy of the model on the same reads (its plain
    version's) where that is larger, as chip_smoke.py phase 16 holds them."""
    import copy

    from m6anet_tpu_torch.data.batching import pack_sites

    weights, threshold, norm = PRETRAINED_CONFIGS[name]
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        model = load_model(tomllib.load(f), weights)
    dataset = build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")
    run_inference(model, dataset, str(tmp_path / "torch"), threshold, backend="torch")
    (batch,) = pack_sites(dataset.iter_sites(), read_capacity=8192, site_capacity=128)
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in
                             (batch.features, batch.kmer_ids, batch.offsets, batch.counts))
    n = int(counts.sum())
    fp = fik.prepare_fused_params_t(model)
    with torch.no_grad():
        exact = copy.deepcopy(model).double().per_read_probability({"X": X[:n].double(), "kmer": K[:n].long()})
    for precision, tol in (("f32", 1e-6), ("f32x3", 2e-5)):
        before = fik.launch_count, fik.site_reduce_launch_count
        run_inference(model, dataset, str(tmp_path / precision), threshold, backend="cuda_fused", precision=precision)
        assert fik.launch_count > before[0] and fik.site_reduce_launch_count > before[1]
        plain = fik.fused_inference_t_plain(fp, X, K, None, offsets, counts, threshold, 20, precision)[0]
        own_error = float((plain[:n].double() - exact).abs().max())
        _assert_runs_close(tmp_path / precision, tmp_path / "torch", threshold, max(tol, 2 * own_error))


def test_torch_backend_matches_the_f32_kernel_at_the_production_batch(cuda_device):
    """The torch backend's step (the model's blocks, the first block's eval
    BatchNorm folded into its GEMM) against cuda_fused at f32 (the kernels'
    own fold) on the released HCT116_RNA002 model at the production batch
    (1,048,576 reads, 16,384 sites), at the kernel-vs-plain tolerances:
    p 1e-6, site_p 1e-5, mod_ratio equal at every site with no read within
    1e-6 of the threshold."""
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.scripts._sweep import production_batch

    model = _model().to(cuda_device).eval()
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in production_batch())
    n_sites = counts.shape[0]
    with torch.no_grad():
        got, want = (engine.make_infer_step(model, n_sites, DEFAULT_READ_THRESHOLD, backend=backend,
                                            precision="f32")(X, K, offsets, counts)
                     for backend in ("torch", "cuda_fused"))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    site_ids = site_ops.derive_site_ids(offsets, counts, X.shape[0], n_sites).long()
    near = ((want[0] - DEFAULT_READ_THRESHOLD).abs() < 1e-6).int()
    held = torch.zeros(n_sites + 1, dtype=torch.int32, device=cuda_device).index_add_(0, site_ids, near)[:n_sites] == 0
    assert int(held.sum()) > n_sites // 2
    assert torch.equal(got[2][held], want[2][held])


def test_signal_config_under_auto_on_the_card_matches_cpu(cuda_device, tmp_path):
    """prod_pooling_signal.toml (seeded weights): auto on the card takes the
    torch backend, whose step launches the per-read tail's kernel and phase
    B once a batch and no other kernel of the port, and matches the CPU's
    run (per read 1e-6, per site 1e-5, mod_ratio equal)."""
    from m6anet_tpu_torch.constants import SIGNAL_MODEL_CONFIG
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.models.mil import MILModel

    with open(SIGNAL_MODEL_CONFIG, "rb") as f:
        model = MILModel(tomllib.load(f)).init(torch.Generator().manual_seed(0)).eval()
    assert engine.resolve_backend(model, "auto", "auto", cuda_device) == ("torch", "f32")
    run_inference(model, _dataset(), str(tmp_path / "cpu"), DEFAULT_READ_THRESHOLD, device="cpu")
    before = (fik.launch_count, fik.site_reduce_launch_count, encoder_kernel.launch_count, mc_kernel.launch_count,
              dict(fik.tc_launch_counts), encoder_kernel.tail_launch_count)
    run_inference(model, _dataset(), str(tmp_path / "card"), DEFAULT_READ_THRESHOLD)
    batches = encoder_kernel.tail_launch_count - before[5]
    assert batches >= 1
    assert (fik.launch_count, fik.site_reduce_launch_count - batches, encoder_kernel.launch_count,
            mc_kernel.launch_count, dict(fik.tc_launch_counts)) == before[:5]
    _assert_runs_close(tmp_path / "card", tmp_path / "cpu", DEFAULT_READ_THRESHOLD, 1e-6)


def _tail_model(name, device):
    """The signal-only config (seeded weights, its BatchNorm's running
    statistics moved off their init) or the released HCT116_RNA002 model,
    on ``device``."""
    from m6anet_tpu_torch.constants import SIGNAL_MODEL_CONFIG

    if name == "production":
        return _model().to(device).eval()
    with open(SIGNAL_MODEL_CONFIG, "rb") as f:
        model = MILModel(tomllib.load(f)).init(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        bn = model.blocks[2].bn
        bn.running_mean.copy_(torch.rand(bn.running_mean.shape, generator=g) - 0.5)
        bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) + 0.2)
    return model.to(device)


@pytest.mark.parametrize("method", ["exact", "mc"])
@pytest.mark.parametrize("name", ["signal", "production"])
def test_fused_tail_matches_the_modules_on_the_card(cuda_device, monkeypatch, name, method):
    """The torch step on the card, whose per-read tail is one launch of the
    tail's kernel, against the same step on the plain modules (cuBLAS,
    TF32 off), over the production batch and the batches that end the
    kernel's 512-read tile raggedly; the signal-only config and the
    production blocks under --backend torch.  Tolerances: p 1e-6, the
    kernel-vs-plain bound of every f32 kernel here (both sum the same f32
    products in another order); site_p 1e-5 (a site's 1 - mean(1 - p) ** 20
    moves by at most 20 times its reads' mean |dp|, far less in practice:
    the bound the other f32 step tests hold); mod_ratio equal at every site
    with no read within 1e-6 of the threshold.  Against a float64 copy of
    the model the tail is off by no more than twice the modules' own f32
    error, or 1e-6.  One launch a step, and the same bits when repeated;
    with the exact method the site outputs are the plain site ops' bits on
    the step's own p (phase B's kernel computes them)."""
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.scripts._sweep import production_batch

    model = _tail_model(name, cuda_device)
    batches = [production_batch(5)] + fik.ragged_tail_batches(512, seed=2)
    for batch in batches:
        X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in batch)
        n_sites, n = counts.shape[0], int(counts.sum())
        with torch.no_grad():
            before = encoder_kernel.tail_launch_count
            step = engine.make_infer_step(model, n_sites, DEFAULT_READ_THRESHOLD, method=method, backend="torch")
            got, again = step(X, K, offsets, counts), step(X, K, offsets, counts)
            torch.cuda.synchronize()
            assert encoder_kernel.tail_launch_count == before + 2
            with monkeypatch.context() as m:
                m.setattr(encoder_kernel, "tail_params", lambda model: None)
                want = engine.make_infer_step(model, n_sites, DEFAULT_READ_THRESHOLD, method=method,
                                              backend="torch")(X, K, offsets, counts)
            assert encoder_kernel.tail_launch_count == before + 2
            exact = copy.deepcopy(model).double().per_read_probability({"X": X[:n].double(), "kmer": K[:n].long()})
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
        own_error = float((want[0][:n].double() - exact).abs().max())
        assert float((got[0][:n].double() - exact).abs().max()) <= max(1e-6, 2 * own_error)
        site_ids = site_ops.derive_site_ids(offsets, counts, X.shape[0], n_sites).long()
        near = ((want[0] - DEFAULT_READ_THRESHOLD).abs() < 1e-6).int()
        held = torch.zeros(n_sites + 1, dtype=torch.int32, device=cuda_device).index_add_(0, site_ids, near)
        held = held[:n_sites] == 0
        assert torch.equal(got[2][held], want[2][held])
        if method == "exact":
            _assert_site_ops_bits(got, offsets, counts, X.shape[0])


@pytest.mark.parametrize("name", ["signal", "one_position"])
def test_lane_groups_at_every_residue_of_the_tile(cuda_device, name):
    """The f32 phase A that shares h1 across lane groups (G > 1: the
    signal-only model's tail, 9 -> 150 -> 32, and the production
    architecture at one position, (1, 2, 150, 32), seeded) on 3 T seeded
    reads, T its block's tile: against the plain version (the tail's
    modules; read_probability_plain) at 1e-6, the f32 kernel-vs-plain
    bound, and on every batch of the first 2 T + r of them, r in [0, T),
    the same bits as there: the last tile cut at every residue, so also
    every residue of a group's 2 G reads.  Each launch is counted in
    grouped_launch_count."""
    rng = np.random.default_rng(25)
    if name == "signal":
        model = _tail_model(name, cuda_device)
        tp = encoder_kernel.tail_params(model)
        lib = encoder_kernel.tail_lib(tp.widths)
        n_in = tp.widths.n_in
        l1, l2 = model.encoder[-2:]
        pool = model.per_read_filter()

        def kernel(x):
            return encoder_kernel.read_prob_tail(tp, x)

        def plain(x):
            return pool.per_read_prob(l2(l1(x)))
    else:
        w = fik.Widths(1, 2, 150, 32)
        model = MILModel(fik.widths_config(w)).init(torch.Generator().manual_seed(4)).eval()
        fp = fik.prepare_fused_params_t(model.to(cuda_device))
        lib = fik.kernel_lib(w)
        n_in = w.features
        K = rng.integers(0, w.vocab, size=(3 * lib.plan["f32"]["tile_reads"], w.positions)).astype(np.int8)
        K = torch.from_numpy(K).to(cuda_device)

        def kernel(x):
            return encoder_kernel.fused_read_probability(fp, x, K[: x.shape[0]])

        def plain(x):
            return fik.read_probability_plain(fp, x, K[: x.shape[0]])
    assert lib.lane_group > 1 and not lib.plan["f32"]["wide"]
    tile = lib.plan["f32"]["tile_reads"]
    x = torch.from_numpy(rng.standard_normal(size=(3 * tile, n_in), dtype=np.float32)).to(cuda_device)
    before = fik.grouped_launch_count
    with torch.no_grad():
        whole = kernel(x)
        torch.testing.assert_close(whole, plain(x), rtol=0, atol=1e-6)
        for r in range(tile):
            n = 2 * tile + r
            assert same_bits(kernel(x[:n]), whole[:n]), n
    assert fik.grouped_launch_count == before + 1 + tile


def _assert_site_ops_bits(out, offsets, counts, n_reads):
    """site_p and mod_ratio of a torch step on the card: the plain site
    ops' bits on the step's own p."""
    p, site_p, mod_ratio = out
    n_sites = counts.shape[0]
    site_ids = site_ops.derive_site_ids(offsets, counts, n_reads, n_sites)
    assert torch.equal(site_p, site_ops.site_probability_exact(p, site_ids, counts, n_sites))
    assert torch.equal(mod_ratio, site_ops.mod_ratio_exact(p, site_ids, counts, n_sites, DEFAULT_READ_THRESHOLD))


@pytest.mark.parametrize("name", ["tanh", "past_the_fast_plan"])
def test_a_model_outside_the_tail_runs_the_modules_on_the_card(cuda_device, name):
    """A config whose last Linear block is tanh, and one whose tail
    (15 -> 150 -> 132) the kernel file plans wide: the torch step on the
    card launches no tail and gives the modules' per-read probability bit
    for bit; its exact site outputs are phase B's, one launch, the plain
    site ops' bits."""
    from m6anet_tpu_torch.inference import engine

    signal_head = [{"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
                   {"block_type": "ExtractSignal"}]
    production_head = [
        {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
        {"block_type": "KmerMultipleEmbedding", "input_channel": 66, "output_channel": 2,
         "num_neighboring_features": 1},
        {"block_type": "ConcatenateFeatures"}]
    head, n_in, h2, activation = {"tanh": (signal_head, 9, 32, "tanh"),
                                  "past_the_fast_plan": (production_head, 15, 132, "relu")}[name]
    config = {"block": head + [
        {"block_type": "Linear", "input_channel": n_in, "output_channel": 150, "activation": "relu",
         "batch_norm": True},
        {"block_type": "Linear", "input_channel": 150, "output_channel": h2, "activation": activation,
         "batch_norm": False},
        {"block_type": "SigmoidProdPooling", "input_channel": h2, "n_reads_per_site": 20},
    ]}
    model = MILModel(config).init(torch.Generator().manual_seed(0)).eval().to(cuda_device)
    assert encoder_kernel.tail_params(model) is None
    if name == "past_the_fast_plan":  # split and packed, but the kernel file plans these widths wide
        tp = encoder_kernel.prepare_tail_params(model)
        assert tp is not None and encoder_kernel.tail_lib(tp.widths).plan["f32"]["wide"]
    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    before = encoder_kernel.tail_launch_count, fik.site_reduce_launch_count
    with torch.no_grad():
        out = engine.make_infer_step(model, counts.shape[0], DEFAULT_READ_THRESHOLD, backend="torch")(
            X, K, offsets, counts)
        want = model.per_read_probability({"X": X, "kmer": K})
    assert torch.equal(out[0], want)
    assert (encoder_kernel.tail_launch_count, fik.site_reduce_launch_count) == (before[0], before[1] + 1)
    _assert_site_ops_bits(out, offsets, counts, X.shape[0])


def _demo_store(root):
    """A columnar store of the demo's sites, written by the port's writer
    from tests/data's data.json."""
    from m6anet_tpu_torch.data.columnar import ColumnarWriter
    from m6anet_tpu_torch.data.dataset import SiteDataset

    raw = SiteDataset(DATA_DIR, min_reads=0, norm_path=None)
    raw.norm_dict = None
    writer = ColumnarWriter(str(root), 3)
    for site in raw.iter_sites():
        writer.append_site(site.tx_id, site.tx_pos, site.sequence, site.features, site.read_ids)
    writer.finalize()
    return str(root)


class _GenericFeed:
    """A dataset's sites without its ``iter_packed``: the engine packs them
    with ``pack_sites``."""

    def __init__(self, dataset):
        self.dataset, self.max_site_reads = dataset, dataset.max_site_reads

    def __len__(self):
        return len(self.dataset)

    def iter_sites(self, n_threads=1):
        return self.dataset.iter_sites(n_threads)


def _same_csvs(a, b, suffix=""):
    for name in ("data.site_proba.csv", "data.indiv_proba.csv"):
        with open(os.path.join(a, name + suffix), "rb") as f, open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("method", ["exact", "mc"])
def test_columnar_feed_on_the_card_gives_the_generic_feeds_bytes(cuda_device, tmp_path, method):
    """iter_packed's batches through the card's kernels (cuda_fused, f32x3;
    the MC kernel after it) write the bytes the generic feed's batches do,
    in batches of 16 sites, each launching each kernel of the path once."""
    from m6anet_tpu_torch.data.columnar import ColumnarSiteDataset

    ds = ColumnarSiteDataset(_demo_store(tmp_path / "store"), min_reads=DEFAULT_MIN_READS,
                             norm_path=PRETRAINED_CONFIGS["HCT116_RNA002"][2])
    kw = dict(read_capacity=4096, site_capacity=16, method=method, num_iterations=200, seed=3)
    before = (fik.launch_count, fik.tc_launch_counts["f32x3"], mc_kernel.launch_count)
    run_inference(_model(), ds, str(tmp_path / "columnar"), DEFAULT_READ_THRESHOLD, **kw)
    launches = (fik.launch_count - before[0], fik.tc_launch_counts["f32x3"] - before[1],
                mc_kernel.launch_count - before[2])
    assert launches == (7, 7, 7 if method == "mc" else 0)  # 101 sites, 16 a batch
    run_inference(_model(), _GenericFeed(ds), str(tmp_path / "generic"), DEFAULT_READ_THRESHOLD, **kw)
    _same_csvs(tmp_path / "columnar", tmp_path / "generic")


@pytest.mark.parametrize("method", ["exact", "mc"])
def test_host_shards_on_the_card_merge_to_the_whole_run(cuda_device, tmp_path, method):
    from m6anet_tpu_torch.inference.engine import merge_host_shards

    ds = build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=PRETRAINED_CONFIGS["HCT116_RNA002"][2])
    kw = dict(site_capacity=32, method=method, num_iterations=200, seed=3)
    run_inference(_model(), ds, str(tmp_path / "whole"), DEFAULT_READ_THRESHOLD, **kw)
    for host in range(3):
        run_inference(_model(), ds, str(tmp_path / "shards"), DEFAULT_READ_THRESHOLD, host_shard=(host, 3), **kw)
    merge_host_shards(str(tmp_path / "shards"), 3)
    _same_csvs(tmp_path / "shards", tmp_path / "whole")


def test_the_ports_dataprep_then_inference_on_the_card_matches_the_goldens(cuda_device, tmp_path):
    """eventalign.txt to calls with the port alone: its dataprep (as the
    goldens were made, both formats), then the inference CLI on the card
    (auto = cuda_fused f32x3) within the golden CSVs' tolerances, and
    --columnar over the same directory within 5e-5 per read of it."""
    import pandas as pd

    from m6anet_tpu_torch.cli import main
    from m6anet_tpu_torch.inference.outputs import compare_runs

    store = str(tmp_path / "dataprep")
    main(["dataprep", "--eventalign", os.path.join(DATA_DIR, "eventalign.txt"), "--out_dir", store,
          "--min_segment_count", "1", "--format", "both", "--n_processes", "2"])
    before = (fik.tc_launch_counts["f32x3"], fik.site_reduce_launch_count)
    main(["inference", "--input_dir", store, "--out_dir", str(tmp_path / "json")])
    assert fik.tc_launch_counts["f32x3"] > before[0] and fik.site_reduce_launch_count > before[1]
    main(["inference", "--input_dir", store, "--out_dir", str(tmp_path / "columnar"), "--columnar"])
    ki, ks = ["transcript_id", "transcript_position", "read_index"], ["transcript_id", "transcript_position"]
    got_i = pd.read_csv(tmp_path / "json" / "data.indiv_proba.csv").sort_values(ki).reset_index(drop=True)
    got_s = pd.read_csv(tmp_path / "json" / "data.site_proba.csv").sort_values(ks).reset_index(drop=True)
    want_i = pd.read_csv(os.path.join(DATA_DIR, "data.indiv_proba.csv.gz")).sort_values(ki).reset_index(drop=True)
    want_s = pd.read_csv(os.path.join(DATA_DIR, "data.site_proba.csv.gz")).sort_values(ks).reset_index(drop=True)
    assert (got_i[ki].values == want_i[ki].values).all() and (got_s[ks].values == want_s[ks].values).all()
    assert (got_s.n_reads.values == want_s.n_reads.values).all() and (got_s.kmer.values == want_s.kmer.values).all()
    np.testing.assert_allclose(got_i.probability_modified, want_i.probability_modified, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_s.mod_ratio, want_s.mod_ratio, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_s.probability_modified, want_s.probability_modified, rtol=0, atol=1e-2)
    gaps = compare_runs(str(tmp_path / "columnar"), str(tmp_path / "json"), DEFAULT_READ_THRESHOLD, 5e-5, None)
    assert gaps["ok"], gaps


@pytest.mark.parametrize("widths", [(11, 8, 512, 128, 1024), (11, 8, 256, 64), (3, 2, 150, 128), (227, 5, 1, 1),
                                    (11, 8, 64, 128)])
def test_wide_plans_at_every_tail_residue(cuda_device, widths):
    """Each phase A that takes its wide plan at ``widths`` (W12, W10, W9,
    the edge of kernel_limit: 1,816 inputs, H1 = H2 = 1, and a tile of
    fewer steps than the weight buffers in flight) against its
    plain version on 3 T seeded reads, T its block's tile (f32 1e-6, the
    reduced modes as _assert_mode_close holds them), and on every batch of
    the first 2 T + r of them, r in [0, T), the same bits as there: the
    last tile cut at every residue."""
    w = fik.Widths(*widths)
    model = MILModel(fik.widths_config(w)).init(torch.Generator().manual_seed(3)).eval()
    fp = fik.prepare_fused_params_t(model.to(cuda_device))
    rng = np.random.default_rng(11)
    for precision in ("f32", "f32x3", "bf16"):
        if not fik.phase_a_wide(precision, w, 2 if w.vocab > 128 else 1):
            continue
        tile = fik.read_tile_reads(precision, w)
        X = rng.standard_normal(size=(3 * tile, w.features), dtype=np.float32)
        K = rng.integers(0, w.vocab, size=(3 * tile, w.positions)).astype(fik.kmer_dtype(w.vocab))
        Xd, Kd = torch.from_numpy(X).to(cuda_device), torch.from_numpy(K).to(cuda_device)
        whole = encoder_kernel.fused_read_probability(fp, Xd, Kd, precision)
        want = fik.read_probability_plain(fp, Xd, Kd, precision)
        if precision == "f32":
            torch.testing.assert_close(whole, want, rtol=0, atol=1e-6)
        else:
            _assert_mode_close(whole, want, precision, [0, 0])
        for r in range(tile):
            n = 2 * tile + r
            assert same_bits(encoder_kernel.fused_read_probability(fp, Xd[:n], Kd[:n], precision), whole[:n]), (
                precision, n)


def test_steps_ask_no_library_for_its_plan_after_it_loads(cuda_device, monkeypatch):
    """The exact step of the released model (cuda_fused, every precision)
    and of a model whose tensor-core phase A takes the wide plan (W9: H2 =
    128; f32x3 and bf16), the MC step and the signal-only model's torch step (its tail's
    lane groups) on the ragged batch, once; then again with every loaded
    library's plan queries (read_prob_wide, read_prob_lane_group,
    read_prob_tc_config) replaced by functions that fail: each launch
    counter moves as it did the first time, and each output repeats bit for
    bit.  The wrappers count from the plan each library reported when it
    loaded (ops/_native.py)."""
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.ops import _native

    X, K, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in _ragged_batch())
    n_sites = counts.shape[0]
    model = _model().to(cuda_device).eval()
    wide = MILModel(fik.widths_config(fik.Widths(3, 2, 150, 128))).init(torch.Generator().manual_seed(3))
    wide = wide.eval().to(cuda_device)
    steps = [engine.make_infer_step(m, n_sites, DEFAULT_READ_THRESHOLD, 20, "exact", "cuda_fused", precision=p)
             for m, precisions in ((model, ("f32", "f32x3", "bf16")), (wide, ("f32x3", "bf16"))) for p in precisions]
    steps.append(engine.make_infer_step(model, n_sites, DEFAULT_READ_THRESHOLD, 20, "mc", "cuda_fused",
                                        n_iterations=1000, seed=2))
    steps.append(engine.make_infer_step(_tail_model("signal", cuda_device), n_sites, DEFAULT_READ_THRESHOLD,
                                        method="exact", backend="torch"))

    def counters():
        return {"fused_inference_t": fik.launch_count, "site_reduce": fik.site_reduce_launch_count,
                **{f"read_prob_tc_{m}": n for m, n in fik.tc_launch_counts.items()},
                **{f"read_prob_wide_{m}": n for m, n in fik.wide_launch_counts.items()},
                "read_prob_grouped": fik.grouped_launch_count, "read_prob_tail": encoder_kernel.tail_launch_count,
                "mc": mc_kernel.launch_count, "mc_long": mc_kernel.long_launch_count}

    def run():
        before = counters()
        with torch.no_grad():
            out = [step(X, K, offsets, counts) for step in steps]
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in counters().items()}

    first, moved = run()
    assert moved["read_prob_wide_f32x3"] == moved["read_prob_wide_bf16"] == 1 and moved["read_prob_wide_f32"] == 0
    assert moved["read_prob_grouped"] == moved["read_prob_tail"] == moved["mc"] == 1

    def refuse(*args):
        raise AssertionError("a library was asked for its plan after it loaded")

    for lib in list(_native._libraries.values()):
        for name in ("read_prob_wide", "read_prob_lane_group", "read_prob_tc_config"):
            if hasattr(lib.cdll, name):
                monkeypatch.setattr(lib.cdll, name, refuse)
    again, moved_again = run()
    assert moved_again == moved
    for a, b in zip(first, again):
        assert all(same_bits(x, y) for x, y in zip(a, b))
