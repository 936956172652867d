"""Card-only tests of the port: the CUDA kernels and their entry points
against their plain versions, and the engine on the card against the engine
on the CPU.

They skip where no NVIDIA card is usable.  The file imports neither JAX nor
the JAX package, so on a machine without JAX run it without the suite's
conftest, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
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
from m6anet_tpu_torch.ops import encoder_kernel, mc_kernel, random
from m6anet_tpu_torch.ops import fused_infer_kernel as fik

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
    with pytest.raises(ValueError, match="kmer_ids"):
        fik.fused_inference_t(fp, X, bad, None, offsets, counts, 0.5)


def _dataset():
    norm = PRETRAINED_CONFIGS["HCT116_RNA002"][2]
    return build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=norm, mode="Inference")


def test_engine_on_the_card_matches_cpu_and_repeats_bit_for_bit(cuda_device, tmp_path):
    thr = PRETRAINED_CONFIGS["HCT116_RNA002"][1]
    run_inference(_model(), _dataset(), str(tmp_path / "cpu"), thr, device="cpu")
    before = fik.launch_count
    run_inference(_model(), _dataset(), str(tmp_path / "a"), thr)  # default device: cuda
    assert fik.launch_count == before + 1
    run_inference(_model(), _dataset(), str(tmp_path / "b"), thr, read_capacity=1024, site_capacity=8)
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


def test_mc_kernel_matches_plain_and_repeats(cuda_device):
    rng = np.random.default_rng(5)
    n_sites = 300
    counts = rng.integers(2, 200, size=n_sites).astype(np.int32)
    counts[:7] = [1, 128, 129, 1000, 1024, 0, 20000]  # 20,000: 80 KB of shared memory
    counts[-20:] = 0  # padding sites
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    offsets[counts == 0] = 0
    p = rng.uniform(0, 0.3, size=int(counts.sum()) + 100).astype(np.float32)
    p[offsets[8]] = 1.0  # the -1e4 clamp
    p, offsets, counts = (torch.from_numpy(a).to(cuda_device) for a in (p, offsets, counts))
    for n_iters in (300, 1500):
        u = torch.from_numpy(random.shared_draws(3, n_iters)).to(cuda_device)
        before = mc_kernel.launch_count
        got = mc_kernel.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
        again = mc_kernel.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
        want = mc_kernel.site_probability_mc_plain(p, offsets, counts, u, n_iters)
        torch.cuda.synchronize()
        assert mc_kernel.launch_count == before + 2
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert torch.equal(got, again)
        assert bool((got[counts == 0] == 0).all()) and bool(torch.isfinite(got).all())
    cap = mc_kernel.MAX_SITE_READS
    big = torch.tensor([cap + 1], dtype=torch.int32, device=cuda_device)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match=f"above the {cap}"):
        mc_kernel.site_probability_mc_cuda(torch.rand(cap + 1, device=cuda_device), zero, big, u, 1500)
    with pytest.raises(ValueError, match="u has shape"):
        mc_kernel.site_probability_mc_cuda(p, offsets, counts, u[:, :100], 1500)


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
