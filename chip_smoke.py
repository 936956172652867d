"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives m6anet_tpu_torch's paths on the card — ``inference`` with the
production model and the exact site method (the main path), the MC site
method, and the encoder-kernel backend — and holds every kernel against its
plain PyTorch version:

  1. device      require CUDA, print the card's name and power limit, TF32 off
  2. build       compile every ops/csrc/*.cu kernel (one nvcc each, in parallel)
  3. small       fused_inference_t vs plain on a small ragged batch
  4. full        fused_inference_t vs plain at the production batch
                 (1,048,576 reads / 16,384 sites), and two launches bit-identical
  5. e2e         the inference CLI on tests/data (default device, --backend
                 auto) against the golden CSVs, with the kernel's launches as
                 the run reports them; the other three pretrained models once
  6. timing      kernel, plain version and bound at the production batch
  7. entries     fused_read_probability and fused_inference vs plain, small
                 and at the production batch, repeats bit-identical
  8. MC small    the MC kernel vs plain on a ragged batch: counts 1, 128, 129,
                 1000 and 20,000 (80 KB of shared memory), padding sites, a
                 read with p = 1, 1,500 iterations (two chunks of draws)
  9. MC full     the MC kernel vs plain at the production batch (p from the
                 fused kernel), 1,000 iterations, two launches bit-identical
 10. MC e2e      the CLI with --site_proba_method mc --num_iterations 2000
                 (default device and backend) against the golden CSVs, and
                 the CLI with --backend cuda (the encoder kernel alone), each
                 with its kernels' launches as its run reports them
 11. timing      the MC kernel and the two entry points: kernel, plain
                 version and bound at the production batch

Any failure exits nonzero.  The last line is the
``{"ok": true, "device": {...}}`` result; before it come the kernels' JSON
line, a timing line and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")
THRESHOLD = 0.033379376  # HCT116_RNA002's read threshold
P_ATOL, SITE_ATOL = 1e-6, 1e-5
GOLDEN_ATOL = {"indiv": 1e-5, "mod_ratio": 1e-6, "site": 1e-2}
MC_SITE_GOLDEN_ATOL = 1.5e-2  # the MC method's (tests/test_inference.py:61)
MC_ATOL = 1e-6  # MC kernel vs plain: the same f32 draws, sums over t in f64
MC_ITERS, MC_E2E_ITERS = 1000, 2000

# (f32 FLOP/s outside the tensor cores, device-memory bytes/s) by card,
# NVIDIA data sheets, dense rates at the full power limit
CARD_RATES = [
    ("H100 PCIe", 51e12, 2.0e12),
    ("H100 NVL", 60e12, 3.9e12),
    ("H200", 67e12, 4.8e12),
    ("H100", 67e12, 3.35e12),  # SXM (e.g. "NVIDIA H100 80GB HBM3")
]

FLOP_PER_READ = 2 * (15 * 150 + 150 * 32 + 32)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAILED: {msg}")
    sys.exit(1)


def card_rates(name: str):
    for key, flops, bw in CARD_RATES:
        if key in name:
            return flops, bw
    fail(f"no peak rates known for card {name!r}")


# ------------------------------------------------------------------ batches
def make_batch(rng, n_reads, n_sites, draw_count):
    """A pack_sites-shaped batch: sites back to back from read 0, padding
    reads after sum(counts), padding sites (count 0) after the last site."""
    features = rng.normal(size=(n_reads, 9)).astype(np.float32)
    kmer = rng.integers(0, 66, size=(n_reads, 3)).astype(np.int8)
    offsets = np.zeros(n_sites, np.int32)
    counts = np.zeros(n_sites, np.int32)
    cursor = 0
    for s in range(n_sites):
        n = draw_count(s)
        if n == 0 or cursor + n > n_reads:
            break
        offsets[s], counts[s] = cursor, n
        cursor += n
    return features, kmer, offsets, counts


def small_count(rng):
    def draw(s):
        if s >= 120:  # 8 padding sites
            return 0
        if s % 10 == 0:
            return 1
        if s in (5, 55):
            return 1000
        return int(rng.integers(2, 30))

    return draw


def production_count(rng):
    # HEK293T-shaped read counts: clip(gamma(2, 30), 20, 1000), mean ~60
    return lambda s: int(min(max(rng.gamma(2.0, 30.0), 20), 1000))


def compare(fik, fp, batch, label):
    """Kernel vs plain on one batch (and the kernel against itself); returns
    the largest absolute difference over p, site_p and the mod_ratios of
    sites with no read near the threshold."""
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    args = (features, kmer, None, offsets, counts, THRESHOLD)
    got = fik.fused_inference_t(fp, *args)
    again = fik.fused_inference_t(fp, *args)
    want = fik.fused_inference_t_plain(fp, *args)
    torch.cuda.synchronize()
    p, site_p, mod_ratio = got
    p_ref, site_ref, mr_ref = want
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    err_p = float((p - p_ref).abs().max())
    err_site = float((site_p - site_ref).abs().max())
    # mod_ratio must be equal except where a read's plain p lies within
    # 1e-6 of the threshold: such reads may fall on either side
    near = ((p_ref - THRESHOLD).abs() < 1e-6).float()
    n_real = int(counts.sum())
    site_ids = torch.full((p.numel(),), counts.numel(), dtype=torch.long, device=p.device)
    site_ids[:n_real] = torch.repeat_interleave(torch.arange(counts.numel(), device=p.device), counts.long())
    ambiguous = torch.zeros(counts.numel() + 1, device=p.device).index_add_(0, site_ids, near)[:-1]
    hit_diff = (mod_ratio - mr_ref).abs() * counts.clamp(min=1).float()
    mr_bad = int((hit_diff > ambiguous + 0.5).sum())
    err_mr = float(torch.where(ambiguous > 0, torch.zeros_like(hit_diff), (mod_ratio - mr_ref).abs()).max())
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    log(
        f"[{label}] reads={p.numel()} sites={counts.numel()} real_reads={n_real} "
        f"real_sites={int((counts > 0).sum())} max|dp|={err_p:.3e} "
        f"max|dsite_p|={err_site:.3e} max|dmod_ratio| (clear sites)={err_mr:.3e} "
        f"reads within 1e-6 of threshold={int(near.sum())} repeat_identical={identical}"
    )
    if not finite:
        fail(f"{label}: non-finite kernel output")
    if err_p > P_ATOL or err_site > SITE_ATOL or mr_bad or err_mr > 0:
        fail(f"{label}: kernel disagrees with plain version")
    if not identical:
        fail(f"{label}: two launches differ")
    return max(err_p, err_site, err_mr)


def compare_entries(fik, enc, site_ops, fp, batch, label):
    """fused_read_probability and fused_inference vs their plain versions
    (and each against itself); returns the largest absolute difference."""
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    n, n_sites = features.shape[0], counts.shape[0]
    site_ids = site_ops.derive_site_ids(offsets, counts, n, n_sites)
    p = enc.fused_read_probability(fp, features, kmer)
    p_again = enc.fused_read_probability(fp, features, kmer)
    p_ref = enc.fused_read_probability_plain(fp, features, kmer)
    got = fik.fused_inference(fp, features, kmer, site_ids, counts, THRESHOLD)
    again = fik.fused_inference(fp, features, kmer, site_ids, counts, THRESHOLD)
    want = fik.fused_inference_plain(fp, features, kmer, site_ids, counts, THRESHOLD)
    torch.cuda.synchronize()
    err_read = float((p - p_ref).abs().max())
    err_p = float((got[0] - want[0]).abs().max())
    err_site = float((got[1] - want[1]).abs().max())
    near = (want[0] - THRESHOLD).abs() < 1e-6
    hit_diff = (got[2] - want[2]).abs() * counts.clamp(min=1).float()
    ambiguous = torch.zeros(n_sites + 1, device=p.device).index_add_(0, site_ids.long(), near.float())[:-1]
    mr_bad = int((hit_diff > ambiguous + 0.5).sum())
    identical = torch.equal(p, p_again) and all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[{label}] fused_read_probability max|dp|={err_read:.3e}; fused_inference max|dp|={err_p:.3e} "
        f"max|dsite_p|={err_site:.3e} mod_ratio sites off={mr_bad} repeat_identical={identical}")
    if not (torch.isfinite(p).all() and all(torch.isfinite(t).all() for t in got)):
        fail(f"{label}: non-finite output")
    if err_read > P_ATOL or err_p > P_ATOL or err_site > SITE_ATOL or mr_bad:
        fail(f"{label}: an entry point disagrees with its plain version")
    if not identical:
        fail(f"{label}: two launches differ")
    return {"fused_read_probability": err_read, "fused_inference": max(err_p, err_site)}


def mc_small_batch(rng):
    """A ragged MC batch: counts 1, 128, 129, 1000 and 20,000 (above the
    48 KB of shared memory a block gets without opting in), a site whose
    only read has p = 1 (the -1e4 clamp), short sites, then padding sites
    (count 0) and padding reads."""
    counts = [1, 128, 129, 1000, 20000, 1] + [int(c) for c in rng.integers(2, 60, size=200)] + [0] * 16
    counts = np.array(counts, np.int32)
    offsets = np.zeros_like(counts)
    offsets[1:] = np.cumsum(counts)[:-1]
    offsets[counts == 0] = 0
    p = rng.uniform(0.0, 0.3, size=int(counts.sum()) + 64).astype(np.float32)
    p[offsets[5]] = 1.0
    return p, offsets, counts


def compare_mc(mck, p, offsets, counts, u, n_iters, label):
    """The MC kernel vs its plain version, and two launches bit-identical."""
    got = mck.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
    again = mck.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
    want = mck.site_probability_mc_plain(p, offsets, counts, u, n_iters)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    identical = torch.equal(got, again)
    real = counts > 0
    log(f"[{label}] sites={counts.numel()} real_sites={int(real.sum())} reads={int(counts.sum())} "
        f"n_iters={n_iters} max|dsite_p|={err:.3e} site_p range=[{float(got[real].min()):.4f}, "
        f"{float(got[real].max()):.4f}] repeat_identical={identical}")
    if not bool(torch.isfinite(got).all()) or bool((got[~real] != 0).any()):
        fail(f"{label}: non-finite site_p, or a padding site not 0")
    if err > MC_ATOL:
        fail(f"{label}: MC kernel disagrees with its plain version")
    if not identical:
        fail(f"{label}: two MC launches differ")
    return err


def device_split_ms(fn, reps=5):
    """Device time per call of each CUDA kernel ``fn`` runs, from
    torch.profiler; empty when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for event in prof.key_averages():
        us = getattr(event, "device_time_total", 0)
        if us > 0:
            split[event.key[:70]] = us / reps / 1e3
    return split


def time_ms(fn, reps=30, flush_bytes=1 << 30):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    with the L2 cache flushed before each run (the real step finds its
    inputs freshly copied, not resident from the previous call).  The 1 GB
    flush keeps the card busy while the host enqueues ``fn``, so the host's
    launch overhead does not show up as device time."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        scratch.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- end to end
def run_cli(model_name, out_dir, extra=()):
    cmd = [
        sys.executable, "-m", "m6anet_tpu_torch", "inference",
        "--input_dir", os.path.join(ROOT, "tests", "data"), "--out_dir", out_dir,
        "--pretrained_model", model_name, *extra,
    ]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - start
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
        fail(f"inference CLI ({model_name}) exited {proc.returncode}")
    path = re.search(r"inference path: (.*)", proc.stderr)
    stages = re.search(r"inference stages: (.*)", proc.stderr)
    batches = re.search(r"batches dispatched: (\d+)", proc.stderr)
    launches = re.search(r"kernel launches: (\{.*\})", proc.stderr)
    if path is None or stages is None or batches is None or launches is None:
        log(proc.stderr[-4000:])
        fail("inference CLI did not report its path, stages, batches and kernel launches")
    return (
        wall, f"{path.group(1)}; stages {stages.group(1)}",
        int(batches.group(1)), json.loads(launches.group(1)),
    )


def check_golden(out_dir, site_atol=GOLDEN_ATOL["site"], label="e2e"):
    import pandas as pd

    data = os.path.join(ROOT, "tests", "data")
    ki = ["transcript_id", "transcript_position", "read_index"]
    ks = ["transcript_id", "transcript_position"]
    got_i = pd.read_csv(os.path.join(out_dir, "data.indiv_proba.csv")).sort_values(ki).reset_index(drop=True)
    want_i = pd.read_csv(os.path.join(data, "data.indiv_proba.csv.gz")).sort_values(ki).reset_index(drop=True)
    got_s = pd.read_csv(os.path.join(out_dir, "data.site_proba.csv")).sort_values(ks).reset_index(drop=True)
    want_s = pd.read_csv(os.path.join(data, "data.site_proba.csv.gz")).sort_values(ks).reset_index(drop=True)
    if len(got_i) != len(want_i) or len(got_s) != len(want_s):
        fail("golden: row counts differ")
    if not (got_i[ki].values == want_i[ki].values).all() or not (got_s[ks].values == want_s[ks].values).all():
        fail("golden: keys differ")
    if not ((got_s.n_reads == want_s.n_reads).all() and (got_s.kmer == want_s.kmer).all()):
        fail("golden: n_reads or kmer differ")
    errs = {
        "indiv": float((got_i.probability_modified - want_i.probability_modified).abs().max()),
        "mod_ratio": float((got_s.mod_ratio - want_s.mod_ratio).abs().max()),
        "site": float((got_s.probability_modified - want_s.probability_modified).abs().max()),
    }
    tol = dict(GOLDEN_ATOL, site=site_atol)
    log(f"[{label}] golden max errors {errs} (tolerances {tol})")
    if any(errs[k] > tol[k] for k in errs):
        fail(f"{label} golden: outside tolerance")


def check_finite(out_dir, n_sites, n_reads):
    import pandas as pd

    site = pd.read_csv(os.path.join(out_dir, "data.site_proba.csv"))
    indiv = pd.read_csv(os.path.join(out_dir, "data.indiv_proba.csv"))
    values = np.concatenate([
        site.probability_modified.values, site.mod_ratio.values, indiv.probability_modified.values,
    ])
    if len(site) != n_sites or len(indiv) != n_reads or not np.isfinite(values).all():
        fail(f"{out_dir}: {len(site)} site / {len(indiv)} read rows, or non-finite values")


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke.py needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    peak_flops, peak_bw = card_rates(kind)

    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
    from m6anet_tpu_torch.models import load_model
    from m6anet_tpu_torch.ops import _build
    from m6anet_tpu_torch.ops import encoder_kernel as enc
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.ops import mc_kernel as mck
    from m6anet_tpu_torch.ops import random as prng
    from m6anet_tpu_torch.ops import site_ops

    # ---- 2. build
    built = _build.build_cuda()
    for name in ("fused_infer", "mc"):
        if name not in built:
            fail(f"ops/csrc/{name}.cu was not built")
    for name, (path, seconds) in built.items():
        with open(path + ".log") as f:
            usage = [ln.strip() for ln in f if "registers" in ln]
        log(f"[build] {name}: {seconds:.1f} s; ptxas: {' | '.join(usage)}")

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        model = load_model(tomllib.load(f), PRETRAINED_CONFIGS["HCT116_RNA002"][0]).cuda()
    fp = fik.prepare_fused_params_t(model)

    # ---- 3. small ragged batch, 4. production batch
    rng = np.random.default_rng(0)
    compare(fik, fp, make_batch(rng, 4096, 128, small_count(rng)), "small")
    full_batch = make_batch(rng, 1 << 20, 16384, production_count(rng))
    max_err = compare(fik, fp, full_batch, "full")

    # ---- 5. main path end to end, through the CLI
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    out = os.path.join(WORK_DIR, "HCT116_RNA002")
    # the CLI process starts with every launch count at 0 and reports the
    # batches and launches of its own run
    cli_wall, path, n_batches, launches = run_cli("HCT116_RNA002", out)
    log(f"[e2e] HCT116_RNA002: {cli_wall:.2f} s wall; {path}; {n_batches} batches; "
        f"kernel launches {launches}")
    if "backend=cuda_fused" not in path or "device=cuda" not in path:
        fail(f"main path ran as {path!r}, not the fused CUDA kernel")
    if launches.get("fused_inference_t", 0) < 1 or n_batches < 1:
        fail("the main path did not launch the fused_infer kernel")
    if "fused_inference" not in launches:
        fail("the engine did not report the launches of fused_inference")
    check_golden(out)
    for name in sorted(set(PRETRAINED_CONFIGS) - {"HCT116_RNA002"}):
        other = os.path.join(WORK_DIR, name)
        wall, _, _, other_launches = run_cli(name, other)
        check_finite(other, 101, 5595)
        log(f"[e2e] {name}: {wall:.2f} s wall, rows and values ok, launches {other_launches}")
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    # ---- 6. timing at the production batch
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in full_batch)
    args = (features, kmer, None, offsets, counts, THRESHOLD)
    kernel_ms = time_ms(lambda: fik.fused_inference_t(fp, *args))
    plain_ms = time_ms(lambda: fik.fused_inference_t_plain(fp, *args))
    split = device_split_ms(lambda: fik.fused_inference_t(fp, *args))
    log(f"[timing] device time per step by kernel (torch.profiler, ms): {split or 'not measured'}")
    n_reads, n_sites = features.shape[0], counts.shape[0]
    flops = n_reads * FLOP_PER_READ + 3 * int(counts.sum())
    bytes_moved = (
        features.numel() * 4 + kmer.numel() + (offsets.numel() + counts.numel()) * 4
        + fp.packed.numel() * 4 + n_reads * 4 + 2 * n_sites * 4
    )
    flop_ms, byte_ms = flops / peak_flops * 1e3, bytes_moved / peak_bw * 1e3
    bound_ms = max(flop_ms, byte_ms)
    kernels = [{
        "name": "fused_inference_t",
        "route": "cuda",
        "source": "m6anet_tpu_torch/ops/csrc/fused_infer.cu",
        "replaces": _replaces("fused_infer.cu"),
        "launches": launches["fused_inference_t"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the encoder and the per-site reductions",
        "launches_per_batch": launches["fused_inference_t"] / n_batches,
        "path": "inference, exact (phase 5)",
    }]

    # ---- 7. the entry points of fused_infer.cu for TPU kernels #3 and #4
    entry_errs = compare_entries(fik, enc, site_ops, fp, make_batch(rng, 4096, 128, small_count(rng)), "entries small")
    full_errs = compare_entries(fik, enc, site_ops, fp, full_batch, "entries full")
    entry_errs = {k: max(entry_errs[k], full_errs[k]) for k in entry_errs}

    # ---- 8. MC small ragged batch, 9. MC at the production batch
    mc_errs = []
    p_s, off_s, cnt_s = (torch.from_numpy(a).cuda() for a in mc_small_batch(rng))
    u_small = torch.from_numpy(prng.shared_draws(0, 1500)).cuda()
    mc_errs.append(compare_mc(mck, p_s, off_s, cnt_s, u_small, 1500, "MC small"))
    p_full = fik.fused_inference_t(fp, *args)[0]
    u_full = torch.from_numpy(prng.shared_draws(0, MC_ITERS)).cuda()
    mc_errs.append(compare_mc(mck, p_full, offsets, counts, u_full, MC_ITERS, "MC full"))

    # ---- 10. the MC path and the encoder-kernel path end to end
    os.makedirs(WORK_DIR)
    out = os.path.join(WORK_DIR, "mc")
    mc_wall, mc_path, mc_batches, mc_launches = run_cli(
        "HCT116_RNA002", out, ["--site_proba_method", "mc", "--num_iterations", str(MC_E2E_ITERS)])
    log(f"[MC e2e] {mc_wall:.2f} s wall; {mc_path}; {mc_batches} batches; kernel launches {mc_launches}")
    if "backend=cuda_fused" not in mc_path or "device=cuda" not in mc_path:
        fail(f"the MC path ran as {mc_path!r}, not on the CUDA kernels")
    if mc_launches.get("site_probability_mc", 0) < 1 or mc_launches.get("fused_inference_t", 0) < 1:
        fail("the MC path did not launch the MC kernel and the fused_infer kernel")
    check_golden(out, MC_SITE_GOLDEN_ATOL, "MC e2e")
    out = os.path.join(WORK_DIR, "encoder")
    enc_wall, enc_path, enc_batches, enc_launches = run_cli("HCT116_RNA002", out, ["--backend", "cuda"])
    log(f"[cuda e2e] {enc_wall:.2f} s wall; {enc_path}; {enc_batches} batches; kernel launches {enc_launches}")
    if "backend=cuda " not in enc_path or enc_launches.get("fused_read_probability", 0) < 1:
        fail("--backend cuda did not launch the encoder kernel")
    check_golden(out, label="cuda e2e")
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    # ---- 11. timing of the MC kernel and the two entry points
    mc_ms = time_ms(lambda: mck.site_probability_mc_cuda(p_full, offsets, counts, u_full, MC_ITERS))
    mc_plain_ms = time_ms(lambda: mck.site_probability_mc_plain(p_full, offsets, counts, u_full, MC_ITERS), reps=5)
    mc_split = device_split_ms(lambda: mck.site_probability_mc_cuda(p_full, offsets, counts, u_full, MC_ITERS))
    log(f"[timing] MC device time per call by kernel (torch.profiler, ms): {mc_split or 'not measured'}")
    real = counts > 0
    n_real_sites, n_real_reads = int(real.sum()), int(counts.sum())
    mc_ops = n_real_sites * MC_ITERS * (20 + 1) + n_real_reads
    mc_bytes = 4 * n_real_reads + 4 * u_full.numel() + 8 * n_sites + 4 * n_sites
    mc_op_ms, mc_byte_ms = mc_ops / peak_flops * 1e3, mc_bytes / peak_bw * 1e3
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gather_ms = n_real_sites * MC_ITERS * 20 / (32 * sms * sm_mhz * 1e6) * 1e3
    kernels.append({
        "name": "site_probability_mc",
        "route": "cuda",
        "source": "m6anet_tpu_torch/ops/csrc/mc.cu",
        "replaces": _replaces("mc.cu"),
        "launches": mc_launches["site_probability_mc"],
        "max_abs_err": max(mc_errs),
        "ms": mc_ms,
        "plain_ms": mc_plain_ms,
        "bound_ms": max(mc_op_ms, mc_byte_ms),
        "bound_by": "operations" if mc_op_ms >= mc_byte_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the sampled noisy-OR",
        "launches_per_batch": mc_launches["site_probability_mc"] / mc_batches,
        "path": f"inference --site_proba_method mc --num_iterations {MC_E2E_ITERS} (phase 10)",
        "shared_memory_gather_ms": gather_ms,
        "device_ms": mc_split,
    })

    site_ids = site_ops.derive_site_ids(offsets, counts, n_reads, n_sites)
    enc_ms = time_ms(lambda: enc.fused_read_probability(fp, features, kmer))
    enc_plain_ms = time_ms(lambda: enc.fused_read_probability_plain(fp, features, kmer))
    enc_flop_ms = n_reads * FLOP_PER_READ / peak_flops * 1e3
    enc_byte_ms = (features.numel() * 4 + kmer.numel() + fp.packed.numel() * 4 + n_reads * 4) / peak_bw * 1e3
    kernels.append({
        "name": "fused_read_probability",
        "route": "cuda",
        "source": "m6anet_tpu_torch/ops/csrc/fused_infer.cu",
        "replaces": _replaces("fused_infer.cu", "read_prob_launch"),
        "launches": enc_launches["fused_read_probability"],
        "max_abs_err": entry_errs["fused_read_probability"],
        "ms": enc_ms,
        "plain_ms": enc_plain_ms,
        "bound_ms": max(enc_flop_ms, enc_byte_ms),
        "bound_by": "operations" if enc_flop_ms >= enc_byte_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the encoder",
        "launches_per_batch": enc_launches["fused_read_probability"] / enc_batches,
        "path": "inference --backend cuda (phase 10)",
    })
    fi_args = (fp, features, kmer, site_ids, counts, THRESHOLD)
    fi_ms = time_ms(lambda: fik.fused_inference(*fi_args))
    fi_plain_ms = time_ms(lambda: fik.fused_inference_plain(*fi_args))
    fi_byte_ms = (bytes_moved - offsets.numel() * 4 + site_ids.numel() * 4) / peak_bw * 1e3
    kernels.append({
        "name": "fused_inference",
        "route": "cuda",
        "source": "m6anet_tpu_torch/ops/csrc/fused_infer.cu",
        "replaces": _replaces("fused_infer.cu", "fused_infer_launch"),
        "launches": launches["fused_inference"],
        "max_abs_err": entry_errs["fused_inference"],
        "ms": fi_ms,
        "plain_ms": fi_plain_ms,
        "bound_ms": max(flop_ms, fi_byte_ms),
        "bound_by": "operations" if flop_ms >= fi_byte_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the encoder and the per-site reductions",
        "launches_per_batch": launches["fused_inference"] / n_batches,
        "path": "inference, exact (phase 5), which does not call it (nor does the JAX "
                "engine); its own count, fused_inference_launch_count",
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "timing": {
            "reads": n_reads, "sites": n_sites, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms,
            "reads_per_s": n_reads / kernel_ms * 1e3, "demo_cli_wall_s": cli_wall,
            "mc_ms": mc_ms, "mc_sites_per_s": n_sites / mc_ms * 1e3, "mc_iters": MC_ITERS,
            "mc_demo_cli_wall_s": mc_wall, "mc_demo_path": mc_path,
            "cuda_backend_demo_cli_wall_s": enc_wall, "cuda_backend_demo_path": enc_path,
            "card": smi,
        }
    }))
    log(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)


def _replaces(source_name, entry=None):
    """The TPU kernel a CUDA source replaces, from its ``// Replaces:`` line,
    or, for another entry point of the source, from the header line that
    names that entry point."""
    with open(os.path.join(ROOT, "m6anet_tpu_torch", "ops", "csrc", source_name)) as f:
        for line in f:
            if entry is None and line.startswith("// Replaces:"):
                return line.split(":", 1)[1].split("(")[0].strip()
            words = line[2:].split()
            if entry is not None and line.startswith("//") and words[:1] == [entry]:
                return words[1]
    fail(f"{source_name} names no TPU kernel that {entry or 'it'} replaces")


if __name__ == "__main__":
    main()
