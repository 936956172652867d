"""Card-only tests of the port: the CUDA kernel against its plain version,
and the engine on the card against the engine on the CPU.

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
