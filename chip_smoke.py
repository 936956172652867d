"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives m6anet_tpu_torch's main path (``inference`` with the production model
and the exact site method) on the card and holds every kernel of that path
against its plain PyTorch version:

  1. device   require CUDA, print the card's name and power limit, TF32 off
  2. build    compile every ops/csrc/*.cu kernel (one nvcc each, in parallel)
  3. small    kernel vs plain on a small ragged batch
  4. full     kernel vs plain at the production batch (1,048,576 reads /
              16,384 sites), and two launches bit-identical
  5. e2e      the inference CLI on tests/data (default device, --backend
              auto) against the golden CSVs, with the kernel's launches as
              the run reports them; the other three pretrained models once
  6. timing   kernel, plain version and bound at the production batch

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
def run_cli(model_name, out_dir):
    cmd = [
        sys.executable, "-m", "m6anet_tpu_torch", "inference",
        "--input_dir", os.path.join(ROOT, "tests", "data"), "--out_dir", out_dir,
        "--pretrained_model", model_name,
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


def check_golden(out_dir):
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
    log(f"[e2e] golden max errors {errs} (tolerances {GOLDEN_ATOL})")
    if any(errs[k] > GOLDEN_ATOL[k] for k in errs):
        fail("golden: outside tolerance")


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
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    # ---- 2. build
    built = _build.build_cuda()
    if "fused_infer" not in built:
        fail("ops/csrc/fused_infer.cu was not built")
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
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "timing": {
            "reads": n_reads, "sites": n_sites, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms,
            "reads_per_s": n_reads / kernel_ms * 1e3, "demo_cli_wall_s": cli_wall,
            "card": smi,
        }
    }))
    log(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)


def _replaces(source_name):
    """The TPU kernel a CUDA source replaces, from its ``// Replaces:`` line."""
    with open(os.path.join(ROOT, "m6anet_tpu_torch", "ops", "csrc", source_name)) as f:
        for line in f:
            if line.startswith("// Replaces:"):
                return line.split(":", 1)[1].split("(")[0].strip()
    fail(f"{source_name} names no TPU kernel it replaces")


if __name__ == "__main__":
    main()
