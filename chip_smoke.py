"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives m6anet_tpu_torch's paths on the card — ``inference`` with the
production model and the exact site method (the main path, at the default
precision, f32x3), the f32 and bf16 precisions, the MC site method, the
encoder-kernel backend, training, all four released models, the generic
model configs, the columnar store, multi-process runs and the pipeline from
eventalign.txt (the port's own dataprep) — and holds every kernel against
its plain PyTorch version:

  1. device      require CUDA, print the card's name and power limit, TF32 off
  2. build       compile every ops/csrc/*.cu kernel (one nvcc each, in parallel)
  3. small       fused_inference_t (f32) vs plain on a small ragged batch, and
                 on batches whose read count ends phase A's tile raggedly (1,
                 2, 3, 255, 257, one tile +- 1 and 4097 reads)
  4. full        fused_inference_t (f32) vs plain at the production batch
                 (1,048,576 reads / 16,384 sites, made by
                 scripts/_sweep.production_batch as every sweep makes it), and two launches
                 bit-identical; placement: p of batch[k:] is p[k:] of the
                 whole batch, bit for bit, for k = 1, 3, 70, 129
  5. e2e         the inference CLI on tests/data (default device, --backend
                 auto and --precision auto = f32x3: the main path) against the
                 golden CSVs, with the kernels' launches as the run reports
                 them (phase B's launches among them); again with --precision f32 (golden) and --precision
                 bf16 (golden site, per read within 2e-2 of the f32 run); the
                 other three pretrained models once
  6. timing      f32 kernel, plain version and bound at the production batch;
                 phase A's registers and spills (ptxas) and the SM clock
                 read right after the timing
  7. entries     fused_read_probability and fused_inference vs plain, small,
                 on the ragged tails of phase 3 and at the production batch,
                 repeats bit-identical
  8. MC small    the MC kernel vs plain on mc_kernel.ragged_mc_batch (a site
                 at the 57,344-read cap, three of 25,000 reads in a row,
                 counts 1-40, around a bank's width and 1, 128, 129, 1000,
                 1024, 20,000, count-0 sites between real ones, a read with
                 p = 1) at 1,500 iterations (two chunks of draws) and 257
                 (one iteration more than a block has threads)
  9. MC full     the MC kernel vs plain at the production batch (p from the
                 fused kernel), 1,000 iterations; in both phases two
                 launches bit-identical, one checking the sites on the
                 device and one from host arrays, as the engine calls it
 10. MC e2e      the CLI with --site_proba_method mc --num_iterations 2000
                 (default device and backend) against the golden CSVs, and
                 the CLI with --backend cuda (the encoder kernel alone) at
                 --precision f32 and f32x3, each with its kernels' launches
                 as its run reports them
 11. timing      the MC kernel and the two entry points: kernel, plain
                 version and bound at the production batch; every wrapper
                 both ways (inputs checked on the device, with a host sync,
                 and from the host arrays, as the engine calls them), the
                 host cost of the k-mer check, mc_site_kernel's ptxas usage and
                 the SM clock; in a line of their own, the floors of mc.cu's
                 design at this batch (models counted from the batch, the
                 SASS and the card's maximum SM clock, not timings)
 12. modes       phase B's spans: in every precision, sites whose span
                 leaves p give NaN and every other output is bit-identical;
                 phase B on each precision's own p the same bits as the
                 plain site ops on it (the production batch and a small
                 ragged batch, and each with three reads made NaN), and
                 phase B alone on
                 fused_infer_kernel.site_reduce_batch (p at the edges of
                 the exact sums, NaN reads, counts 0 to 57,344);
                 f32x3 and bf16 (read_prob_tc.cu, then phase B of
                 fused_infer.cu) vs plain on a small batch, the ragged tails
                 of each mode's tensor-core tile, the production batch, shifted
                 placements (bit for bit, across 64-read tiles and 16-byte
                 boundaries) and both entry points; f32x3 p within 2e-6 and
                 99.999% of reads within 1e-6, bf16 p within 1e-3 and 99.9%
                 within 1e-6, site_p 1e-5 (+ 20 max|dp| at a site holding a
                 read further apart), mod_ratio equal but at reads near or
                 across the threshold; repeats bit-identical
 13. timing      each mode's wrapper call (both ways), phase A alone, plain
                 version, device split, bound at the production batch, and
                 read_prob_tc_kernel's registers (ptxas) and launch
                 (threads, consumer warpgroups, ring stages, tile, dynamic
                 shared memory); phase B alone (its wrapper, CUDA events,
                 L2 flushed) beside its bound, its plain version and
                 torch.segment_reduce of 1 - p (a yardstick that computes
                 only the sums); site_reduce_kernel's registers and spills.
                 A wrapper call with host arrays times the pair (phase A
                 then phase B): the flush before it keeps the card busy
                 while the host launches; the torch backend's per-read
                 tail (encoder_kernel.read_prob_tail) at the production
                 batch through the signal-only model (9 -> 150 -> 32):
                 against the tail's modules (per read 1e-6), kernel,
                 modules, cuBLAS with the weights folded once, bound,
                 ptxas, its lane groups (read_prob_lane_group), the torch
                 step's launches a batch (read_prob_grouped among them),
                 and p the same bits as the older fused_infer.cu under
                 build/parent/csrc built as the same tail, the two timed
                 in turns
 14. T1 train    the production model's train step (train/loop.py: the
                 train-mode forward, BCE, backward, optax's global-norm
                 clip, torch.optim.Adam) on the card against the CPU, from
                 the released HCT116 weights and from a seeded init, on
                 seeded 256-site x 20-read batches: the first step, then 20
                 steps each side (TRAIN_* tolerances below); the 20 card
                 steps again, bit for bit or not (reported, not held), and
                 in two fresh processes (torch's defaults, and
                 torch.use_deterministic_algorithms with
                 CUBLAS_WORKSPACE_CONFIG) where the bits part: one step's
                 gradients twice, each product of the backward alone, the
                 20 steps twice; median ms per train step and per eval step
                 (CUDA events) and their kernels (torch.profiler)
 15. T2 CLI      python -m m6anet_tpu_torch train on tests/data (2 epochs,
                 default device), every output file in the JAX package's
                 layout and finite losses; then inference
                 --model_state_dict <save_dir>/avg_loss.npz on the card
                 (cuda_fused, f32, its kernels' launches as the run reports
                 them) against the same command with --device cpu, at the
                 golden tolerances
 16. models      each of the four released models (its own weights, read
                 threshold and norm factors) through run_inference in this
                 process on tests/data, every launch count set to 0 just
                 before each run and read just after: --backend torch on
                 the CPU (the plain version), --backend torch on the card
                 (the per-read tail's kernel and phase B once a batch),
                 cuda_fused at f32, f32x3 and bf16, --backend cuda at f32
                 and the MC method; the card's torch run, f32 and
                 the cuda backend against the CPU's torch run (per read 1e-6,
                 or twice the f32 plain version's error against an f64
                 copy of the model where larger; per site 1e-5 + 20 max|dp|
                 over the site's reads; mod_ratio equal but near the
                 threshold); f32x3 and bf16 per read against that run
                 at the mode's accuracy (2e-5, 2e-2, or twice the mode's
                 error against f64 where larger), and every output against
                 the mode's plain version on the demo's batch written as
                 CSVs, at P_ATOL per read and the site rule above; HCT116
                 against the golden CSVs; each mode's kernel against its
                 plain version on the demo's packed batch, and bf16 at the
                 production batch, at the tolerances of phases 3-12, each
                 check's real reads meeting CLOSE_SHARE on their own
 17. generic     prod_pooling_signal.toml, a ProbabilityAttention config
                 and the signal-only blocks with a tanh last block (seeded
                 weights) through run_inference on the card with
                 --backend auto, which must resolve to torch and launch
                 phase B once a batch, and the per-read tail's kernel once
                 a batch but in the tanh config (which runs its blocks as
                 modules), and no other, against the same run on the CPU
                 (per read 1e-6,
                 per site 1e-5, mod_ratio equal); the signal-only config
                 once more through the CLI (--model_config,
                 --model_state_dict); 20 train steps of the attention-plus-
                 decoder architecture of tests/test_train.py:304, card
                 against CPU, at phase 14's tolerances
 18. columnar    a columnar store of 65,536 sites (four production
                 batches' worth; read counts from _sweep.production_batch's
                 law, the demo's sequence contexts, seeded reads), written
                 by the port's ColumnarWriter: iter_packed's first batch the
                 same bits as pack_sites(iter_sites())'s; both feeds alone
                 on the host (seconds, sites/s); the CLI with --columnar
                 (auto = cuda_fused f32x3) and with --site_proba_method mc,
                 each kernel of the path launched once a batch, their stage
                 seconds and sites/s; the generic feed through the engine
                 over the same store, its CSVs the --columnar run's bytes;
                 on the demo, --columnar against data.json on the card (the
                 store normalises f32 reads in f32, data.json f64 decimals
                 in f64: per read within 5e-5, the JAX package's bound) and
                 against the golden CSVs
 19. shards      on the one card, each against the one-process run's bytes:
                 --distributed (two jobs of two ranks sharing the card, at
                 once: data.json exact and columnar MC), --host_shard 0 2
                 and 1 2 then the merge (exact and MC), --concat_shards over
                 two stores; train --use_mesh on's step (phase 14's 20
                 batches, the last wrap-padded) with one rank, the bits of
                 the step without the job, and with two ranks sharing the
                 card (gloo), within phase 14's tolerances of one rank
 20. pipeline    eventalign.txt to calls with the port alone (the port's
                 native parser must build and load): python -m
                 m6anet_tpu_torch dataprep on tests/data/eventalign.txt
                 (--min_segment_count 1 --format both --n_processes 2),
                 its index, data.info and data.json against the goldens as
                 tests/test_dataprep.py compares them; inference on the card
                 over it (auto = cuda_fused f32x3) against the golden CSVs,
                 and --columnar within 5e-5 per read of that run, with the
                 kernels each run launched; compute_norm_factors over the
                 demo's labelled sites (the labels of
                 tests/data/data.info.labelled on the port's data.info), its
                 means and stds within 1e-9 relative of compute_norm_dict
                 over tests/data/data.json, then train on the card with
                 them (finite losses, a checkpoint); then a 1 GiB
                 eventalign (512 copies of the demo, contigs renamed):
                 dataprep --format both at min(cores, 16) processes and at
                 1 (MB/s, sites/s, the same bytes in every file), the two
                 --host_shard halves at once, inference --columnar on the
                 card (wall, stages, sites/s, launches) and
                 --concat_shards over the shards (the one-store bytes);
                 every number beside the card, its power limit and the
                 host CPU
 21. widths      the production architecture at eight widths (positions
                 P, embedding E, hidden H1, H2): W0 (3, 2, 150, 32), the
                 released models', W1 (5, 2, 150, 32), W2 (3, 3, 100, 20), W3
                 (3, 4, 256, 64), W4 (11, 4, 96, 24), W5 (1, 1, 7, 3), and
                 the envelope's corners W6 (11, 4, 256, 64) and W7 (1, 4,
                 256, 64), seeded weights: each tuple's libraries (built in
                 phase 2, ptxas registers and spills, the tensor-core
                 blocks' shared memory within a block's), every precision
                 against the plain
                 versions at phase 12's tolerances on a small ragged batch,
                 the ragged tails of each phase A's tile and a
                 1,048,576-read batch, repeats bit-identical; both entry
                 points at W3; each tuple's phase A timed beside its f32
                 bound; every tuple bit for bit against the older sources
                 staged under build/parent/csrc (git show of the parent
                 commit's, built in a thread beside phase 2's build;
                 skipped with a note where none are staged) at the
                 production batch (W0 p, site_p and mod_ratio, W1-W7 p),
                 and its phase A times beside theirs, interleaved;
                 train --model_config (W3) on tests/data, 2 epochs, then
                 inference --model_state_dict with --backend auto (must be
                 cuda_fused f32x3, each kernel once a batch) against
                 --backend torch and its plain version; the port's
                 dataprep --n_neighbors 2 (the demo: no site; synthetic
                 long runs: sites whose outer 5-mers the 66-k-mer
                 vocabulary lacks, refused by the dataset in both
                 packages) and run_inference over seeded 5-position sites
                 with a seeded W1 model, auto against torch; a model of
                 (3, 2, 150, 65), past the fast plans' H2, through auto
                 (cuda_fused f32x3 on the wide plan, each kernel once a
                 batch) against torch, and one of 32,768 k-mers (past the
                 int16 ids) refused before any launch
 22. MC shapes   mc_kernel.ragged_mc_batch with sites of 57,345, 100,000
                 and 1,000,000 reads at T = 1, 257, 1000, 1500 and 4097
                 against the plain version (1e-6), the shorter sites the
                 same bits as without the long ones, and through the
                 long-site kernel (launched from count 0); n_samples 1,
                 20, 32, 128 against the plain version (and the long
                 kernel's ptxas registers and spills at each); MC through the engine
                 over a columnar store holding a 100,000-read site,
                 cuda_fused against --backend torch (site 1e-5); at T =
                 1000 one 1,000,000-read site, the three long sites alone
                 and after the production batch's 16,384 sites, 18 sites
                 of 57,345 reads and one of 2^23 - 1 against the plain
                 version, each but the last timed (mc_long_site_kernel
                 alone, bound, latency floor); every site_p of all of
                 these the older mc.cu's bits and both MC kernels timed
                 beside it, where build/parent/csrc/mc.cu is staged
 23. past        the production architecture past the widths of the
                 kernels' fast plans: W8 (3, 2, 512, 32), W9 (3, 2, 150,
                 128), W10 (11, 8, 256, 64), W11 (3, 2, 150, 32) over 1,024
                 k-mers and W12 (11, 8, 512, 128) over 1,024, seeded
                 weights: each tuple's libraries (built in phase 2; ptxas
                 registers and spills of the kernel each phase A launches,
                 the wide plan's or the fast one's), every precision
                 against the plain versions at phase 12's tolerances on a
                 small ragged batch (the dataset's int8 ids), the ragged
                 tails of each phase A's tile and a 1,048,576-read batch
                 (ids over the whole vocabulary, int16 past 128 k-mers),
                 repeats bit-identical; each wide phase A on batches of
                 2 T + r reads for every r < T (T its block's tile), the
                 same bits as the same reads' in one batch; each phase A
                 timed beside its bound, the cuBLAS chain of the same
                 widths (f32 with TF32 off, bf16) on inputs gathered
                 beforehand, and the older sources' phase A (p the same
                 bits in every precision, times interleaved, where
                 staged); both entry points at W12 with int32 ids up to
                 V - 1; a W12 model through run_inference in each
                 precision (the wide kernels once a batch) against
                 --backend torch and its plain version; train
                 --model_config (W9) on tests/data, 2 epochs, then
                 inference --backend auto (cuda_fused f32x3 on the wide
                 plan, each kernel once a batch) against --backend torch

Any failure exits nonzero.  The last line is the
``{"ok": true, "device": {...}}`` result; before it come the MC floors' JSON
line, the models and generic lines (phases 16 and 17), the columnar,
shards and pipeline lines (phases 18 to 20), the widths and MC shapes
lines (phases 21 and 22), the past-envelope line (phase 23), the kernels' JSON
line (measured values and each kernel's bound, phase B's site_reduce_kernel
with its own entry, and each kernel's launches by released model), the
training line (phases 14 and 15), a timing line and the card's
``nvidia-smi`` name and power limit.
The training path runs no hand-written kernel (the JAX package's train step
reaches no Pallas kernel): its products are cuBLAS's.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")
THRESHOLD = 0.033379376  # HCT116_RNA002's read threshold
SITE_ATOL = 1e-5
# kernel vs plain, per read: every read within P_ATOL and CLOSE_SHARE of
# them within 1e-6.  f32x3: the tensor cores' k16 sums round inside the
# chunk in their own way, which the plain version's truncated f64 sums
# model to all but ~1 read in a million (0.99999); bf16: an f32 sum that
# differs in its last bit can round an activation to the neighbouring bf16
# value (0.999)
P_ATOL = {"f32": 1e-6, "f32x3": 2e-6, "bf16": 1e-3}
CLOSE, CLOSE_SHARE = 1e-6, {"f32": 1.0, "f32x3": 0.99999, "bf16": 0.999}
MODES = ("f32x3", "bf16")
# k of the placement check: 70 moves reads across a 64-read tile of the
# tensor-core kernel, and every k but 129 starts features and kmer_ids at
# another offset from a 16-byte boundary (its bulk copies start below it)
PLACEMENT_SHIFTS = (1, 3, 70, 129)
GOLDEN_ATOL = {"indiv": 1e-5, "mod_ratio": 1e-6, "site": 1e-2}
BF16_INDIV_ATOL = 2e-2  # bf16 CLI per read against the f32 CLI (tests/test_ops.py:325)
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
# per read, by the pipe that runs them (FP32 cores, bf16 tensor cores): f32x3
# keeps layer 1 in f32 and takes three bf16 passes over layer 2 and the head
MODE_FLOP_PER_READ = {
    "f32x3": {"f32": 2 * 15 * 150, "bf16": 3 * 2 * (150 * 32 + 32)},
    "bf16": {"f32": 0, "bf16": FLOP_PER_READ},
}
BF16_TENSOR_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet)

# phase 14: the train step on the card against the CPU, at the JAX package's
# test settings (tests/test_train.py) and the reference's batch of 256 sites
# x 20 reads.  Tolerances and why: PERF.md, "Training".  The first step from
# one state: loss 1e-6 relative, each parameter 1e-6, but 2 lr where the
# CPU's gradient is below 1e-6 (Adam's first step lr g / (|g| + 1e-8) turns
# f32 noise there into steps of order lr: block3's bias before BatchNorm,
# dead units).  Twenty steps each side: the two trajectories drift apart
# through those elements, so each step's loss is held to 1e-3 relative and
# every final parameter to 2 lr.
TRAIN_LR, TRAIN_WD, TRAIN_CLIP = 4e-3, 1e-5, 5.0
TRAIN_STEPS, TRAIN_SITES, TRAIN_READS = 20, 256, 20
TRAIN_FIRST_LOSS_RTOL, TRAIN_FIRST_ATOL, TRAIN_UNRESOLVED_GRAD = 1e-6, 1e-6, 1e-6
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-3, 2 * TRAIN_LR

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
def make_batch(rng, n_reads, n_sites, draw_count, widths=(3, 2, 150, 32)):
    """A pack_sites-shaped batch: sites back to back from read 0, padding
    reads after sum(counts), padding sites (count 0) after the last site;
    the reads of a model of ``widths`` (positions first)."""
    positions = widths[0]
    features = rng.normal(size=(n_reads, 3 * positions)).astype(np.float32)
    kmer = rng.integers(0, 66, size=(n_reads, positions)).astype(np.int8)
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


# reads compared and reads more than CLOSE apart, by precision, over every
# kernel-vs-plain check of the run (a share is held over all of them: one
# read of a 129-read tail is 0.8%)
CLOSE_TALLY = {precision: [0, 0] for precision in P_ATOL}


def p_check(p, p_ref, precision):
    """Largest |p - p_ref|, the share of reads within CLOSE, and whether
    every read is within the precision's P_ATOL; counts the reads in
    CLOSE_TALLY."""
    err = (p - p_ref).abs()
    far = int((err > CLOSE).sum())
    CLOSE_TALLY[precision][0] += err.numel()
    CLOSE_TALLY[precision][1] += far
    err_max = float(err.max()) if err.numel() else 0.0
    return err_max, 1.0 - far / max(err.numel(), 1), err_max <= P_ATOL[precision]


def site_check(p, p_ref, site_p, site_ref, site_ids, n_sites):
    """Largest |site_p - site_ref| over the sites whose reads all agree
    within CLOSE, and whether every site is within SITE_ATOL, or, at a site
    holding a read further apart, within SITE_ATOL + 20 max|p - p_ref| (the
    derivative of 1 - m**20 is at most 20, and the mean m moves by at most
    max|p - p_ref|)."""
    err = (p - p_ref).abs()
    far = torch.zeros(n_sites + 1, device=p.device).index_add_(0, site_ids.long(), (err > CLOSE).float())[:-1]
    err_site = (site_p - site_ref).abs()
    allowed = SITE_ATOL + torch.where(far > 0, 20 * err.max(), torch.zeros_like(far))
    clear = float(torch.where(far > 0, torch.zeros_like(err_site), err_site).max())
    return clear, int((far > 0).sum()), bool((err_site <= allowed).all())


def check_close_share(precision):
    n, far = CLOSE_TALLY[precision]
    share = 1.0 - far / max(n, 1)
    log(f"[{precision}] reads within {CLOSE} of the plain version over every check: {n - far} of {n} "
        f"({share:.7f}; at least {CLOSE_SHARE[precision]})")
    if share < CLOSE_SHARE[precision]:
        fail(f"{precision}: too many reads differ from the plain version by more than {CLOSE}")


def compare(fik, fp, batch, label, precision="f32", threshold=THRESHOLD, own_share=False):
    """Kernel vs plain on one batch in ``precision`` (and the kernel against
    itself), p within P_ATOL; with ``own_share`` the batch's real reads
    must also meet CLOSE_SHARE on their own, not only in CLOSE_TALLY.
    Returns the largest absolute difference over p, site_p and the
    mod_ratios of sites with no read near or across the threshold."""
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    args = (features, kmer, None, offsets, counts, threshold, 20, precision)
    got = fik.fused_inference_t(fp, *args)
    again = fik.fused_inference_t(fp, *args)
    want = fik.fused_inference_t_plain(fp, *args)
    torch.cuda.synchronize()
    p, site_p, mod_ratio = got
    p_ref, site_ref, mr_ref = want
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    err_p, close, p_ok = p_check(p, p_ref, precision)
    # mod_ratio must be equal except where a read's plain p lies within
    # 1e-6 of the threshold, or the two p straddle it: such reads may fall
    # on either side
    near = (((p_ref - threshold).abs() < 1e-6) | ((p >= threshold) != (p_ref >= threshold))).float()
    n_real = int(counts.sum())
    far_real = int(((p - p_ref).abs()[:n_real] > CLOSE).sum())
    site_ids = torch.full((p.numel(),), counts.numel(), dtype=torch.long, device=p.device)
    site_ids[:n_real] = torch.repeat_interleave(torch.arange(counts.numel(), device=p.device), counts.long())
    err_site, far_sites, site_ok = site_check(p, p_ref, site_p, site_ref, site_ids, counts.numel())
    ambiguous = torch.zeros(counts.numel() + 1, device=p.device).index_add_(0, site_ids, near)[:-1]
    hit_diff = (mod_ratio - mr_ref).abs() * counts.clamp(min=1).float()
    mr_bad = int((hit_diff > ambiguous + 0.5).sum())
    err_mr = float(torch.where(ambiguous > 0, torch.zeros_like(hit_diff), (mod_ratio - mr_ref).abs()).max())
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    log(
        f"[{label}] precision={precision} reads={p.numel()} sites={counts.numel()} real_reads={n_real} "
        f"real_sites={int((counts > 0).sum())} max|dp|={err_p:.3e} (tolerance {P_ATOL[precision]:.3g}) "
        f"share |dp|<={CLOSE:.3g}={close:.6f} real reads further apart={far_real} "
        f"max|dsite_p| (sites of close reads)={err_site:.3e} sites with a read further apart={far_sites} "
        f"max|dmod_ratio| (clear sites)={err_mr:.3e} "
        f"reads near or across the threshold={int(near.sum())} repeat_identical={identical}"
    )
    if not finite:
        fail(f"{label}: non-finite kernel output")
    if not p_ok or not site_ok or mr_bad or err_mr > 0:
        fail(f"{label}: kernel disagrees with plain version")
    if own_share and 1.0 - far_real / max(n_real, 1) < CLOSE_SHARE[precision]:
        fail(f"{label}: {far_real} of {n_real} reads differ from the plain version by more than {CLOSE} "
             f"(at least {CLOSE_SHARE[precision]} must not)")
    if not identical:
        fail(f"{label}: two launches differ")
    return max(err_p, err_site, err_mr)


def check_placement(fik, enc, fp, batch, precision="f32"):
    """p of batch[k:] (phase A alone) equals p[k:] of the whole batch
    (the fused step), bit for bit: a read's p does not depend on where it
    sits in the tile."""
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    p = fik.fused_inference_t(fp, features, kmer, None, offsets, counts, THRESHOLD, 20, precision)[0]
    same = {k: torch.equal(enc.fused_read_probability(fp, features[k:], kmer[k:], precision), p[k:])
            for k in PLACEMENT_SHIFTS}
    log(f"[placement] precision={precision}: p of batch[k:] == p[k:] of the batch, bit for bit: {same}")
    if not all(same.values()):
        fail("placement: a read's p depends on its place in the batch")


def check_span_fault(fik, fp, batch, precision):
    """Phase B of a batch whose offsets and counts put three sites' spans
    outside p (a negative offset, a negative count, a span past the last
    read): those sites give NaN site_p and mod_ratio, every other output is
    bit-identical to the batch as packed."""
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    n = features.shape[0]
    bad_offsets, bad_counts = offsets.clone(), counts.clone()
    bad_offsets[0] = -1
    bad_counts[1] = -2
    bad_offsets[2], bad_counts[2] = n - 1, 2
    want = fik.fused_inference_t(fp, features, kmer, None, offsets, counts, THRESHOLD, 20, precision)
    got = fik.fused_inference_t(fp, features, kmer, None, bad_offsets, bad_counts, THRESHOLD, 20, precision)
    torch.cuda.synchronize()
    bad = torch.zeros(counts.numel(), dtype=torch.bool, device=counts.device)
    bad[:3] = True
    nan = all(bool(t[bad].isnan().all()) for t in got[1:])
    kept = torch.equal(got[0], want[0]) and all(torch.equal(a[~bad], b[~bad]) for a, b in zip(got[1:], want[1:]))
    log(f"[span fault] precision={precision}: sites whose span leaves p give NaN: {nan}; "
        f"every other output bit for bit: {kept}")
    if not (nan and kept):
        fail("phase B does not give NaN to exactly the sites whose span leaves p")


def check_phase_b(fik, fp, batch, label, precision):
    """Phase B on the kernel's own p of ``precision``: site_p and mod_ratio
    the same bits as the plain site ops give on that p, and phase B alone
    on that p with three reads made NaN (phase A makes no NaN: its ReLU
    drops one)."""
    from m6anet_tpu_torch.scripts._sweep import same_bits

    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    p, site_p, mod_ratio = fik.fused_inference_t(fp, features, kmer, None, offsets, counts, THRESHOLD, 20, precision)
    want = fik.site_reduce_plain(p, offsets, counts, THRESHOLD)
    ok = same_bits(site_p, want[0]) and same_bits(mod_ratio, want[1])
    p[[0, 700, 2000]] = float("nan")
    got_nan = fik.site_reduce(p, offsets, counts, THRESHOLD)
    want_nan = fik.site_reduce_plain(p, offsets, counts, THRESHOLD)
    torch.cuda.synchronize()
    ok_nan = all(same_bits(a, b) for a, b in zip(got_nan, want_nan)) and bool(got_nan[0].isnan().any())
    log(f"[phase B exact] {label} precision={precision}: site_p and mod_ratio the same bits as the plain "
        f"site ops on the kernel's p: {ok}; with three NaN reads: {ok_nan}")
    if not (ok and ok_nan):
        fail(f"phase B on {label} ({precision}) is not bit-identical to the plain site ops")


def check_phase_b_alone(fik):
    """Phase B alone on site_reduce_batch (p at the edges of the exact sums,
    NaN reads, counts 0 to 57,344): the same bits as its plain version, and
    a repeat too."""
    from m6anet_tpu_torch.scripts._sweep import same_bits

    p, offsets, counts = (torch.from_numpy(a).cuda() for a in fik.site_reduce_batch())
    got = fik.site_reduce(p, offsets, counts, THRESHOLD)
    again = fik.site_reduce(p, offsets, counts, THRESHOLD)
    want = fik.site_reduce_plain(p, offsets, counts, THRESHOLD)
    torch.cuda.synchronize()
    ok = all(same_bits(a, b) for a, b in zip(got, want))
    repeat = all(same_bits(a, b) for a, b in zip(got, again))
    log(f"[phase B exact] site_reduce_batch ({counts.numel()} sites, {int(counts.sum())} reads, "
        f"{int(p[: int(counts.sum())].isnan().sum())} NaN reads): the same bits as the plain version: {ok}; "
        f"repeat: {repeat}")
    if not (ok and repeat):
        fail("phase B alone is not bit-identical to its plain version on site_reduce_batch")


def host_check_ms(fik, kmer_host, reps=50):
    """Median host time of checked_kmer_ids on the batch's host ids."""
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fik.checked_kmer_ids(kmer_host)
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def compare_entries(fik, enc, site_ops, fp, batch, label, precision="f32"):
    """fused_read_probability and fused_inference vs their plain versions
    (and each against itself); returns the largest absolute difference."""
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    n, n_sites = features.shape[0], counts.shape[0]
    site_ids = site_ops.derive_site_ids(offsets, counts, n, n_sites)
    p = enc.fused_read_probability(fp, features, kmer, precision)
    p_again = enc.fused_read_probability(fp, features, kmer, precision)
    p_ref = enc.fused_read_probability_plain(fp, features, kmer, precision)
    fi_args = (fp, features, kmer, site_ids, counts, THRESHOLD, 20, precision)
    got = fik.fused_inference(*fi_args)
    again = fik.fused_inference(*fi_args)
    want = fik.fused_inference_plain(*fi_args)
    torch.cuda.synchronize()
    err_read, _, read_ok = p_check(p, p_ref, precision)
    err_p, _, fused_ok = p_check(got[0], want[0], precision)
    err_site, _, site_ok = site_check(got[0], want[0], got[1], want[1], site_ids, n_sites)
    near = ((want[0] - THRESHOLD).abs() < 1e-6) | ((got[0] >= THRESHOLD) != (want[0] >= THRESHOLD))
    hit_diff = (got[2] - want[2]).abs() * counts.clamp(min=1).float()
    ambiguous = torch.zeros(n_sites + 1, device=p.device).index_add_(0, site_ids.long(), near.float())[:-1]
    mr_bad = int((hit_diff > ambiguous + 0.5).sum())
    identical = torch.equal(p, p_again) and all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[{label}] precision={precision} fused_read_probability max|dp|={err_read:.3e}; fused_inference "
        f"max|dp|={err_p:.3e} max|dsite_p|={err_site:.3e} mod_ratio sites off={mr_bad} "
        f"repeat_identical={identical}")
    if not (torch.isfinite(p).all() and all(torch.isfinite(t).all() for t in got)):
        fail(f"{label}: non-finite output")
    if not (read_ok and fused_ok and site_ok) or mr_bad:
        fail(f"{label}: an entry point disagrees with its plain version")
    if not identical:
        fail(f"{label}: two launches differ")
    return {"fused_read_probability": err_read, "fused_inference": max(err_p, err_site)}


def compare_mc(mck, p, offsets, counts, host_sites, u, n_iters, label):
    """The MC kernel vs its plain version, and two launches bit-identical:
    one checking the sites on the device, one from the host arrays."""
    got = mck.site_probability_mc_cuda(p, offsets, counts, u, n_iters)
    again = mck.site_probability_mc_cuda(p, offsets, counts, u, n_iters, host_sites=host_sites)
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


def device_split_ms(fn, reps=20):
    """Device time per launch of each CUDA kernel ``fn`` runs, from
    torch.profiler (its total over the launches the profiler recorded, which
    may be fewer than ``reps``); empty when it sees no device activity."""
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
            split[event.key[:70]] = us / max(event.count, 1) / 1e3
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
def run_cli(model_name, out_dir, extra=(), input_dir=os.path.join(ROOT, "tests", "data")):
    cmd = [
        sys.executable, "-m", "m6anet_tpu_torch", "inference",
        "--input_dir", *([input_dir] if isinstance(input_dir, str) else input_dir), "--out_dir", out_dir,
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


def check_golden(out_dir, site_atol=GOLDEN_ATOL["site"], label="e2e", only_site=False):
    """The CLI's CSVs against the golden ones: rows and keys equal, values
    within GOLDEN_ATOL (site within ``site_atol``; with ``only_site`` the
    site probability alone is held)."""
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
    tol = {"site": site_atol} if only_site else dict(GOLDEN_ATOL, site=site_atol)
    log(f"[{label}] golden max errors {errs} (tolerances {tol})")
    if any(errs[k] > tol[k] for k in tol):
        fail(f"{label} golden: outside tolerance")
    return errs


def check_finite(out_dir, n_sites, n_reads):
    import pandas as pd

    site = pd.read_csv(os.path.join(out_dir, "data.site_proba.csv"))
    indiv = pd.read_csv(os.path.join(out_dir, "data.indiv_proba.csv"))
    values = np.concatenate([
        site.probability_modified.values, site.mod_ratio.values, indiv.probability_modified.values,
    ])
    if len(site) != n_sites or len(indiv) != n_reads or not np.isfinite(values).all():
        fail(f"{out_dir}: {len(site)} site / {len(indiv)} read rows, or non-finite values")


# ------------------------------------------------------------- training
def train_batches(seed, n_batches):
    """Seeded synthetic batches of the loader's layout: X (B, 20, 9) f32,
    kmer (B, 20, 3) int32, y (B,) f32."""
    rng = np.random.default_rng(seed)
    return [{
        "X": rng.normal(size=(TRAIN_SITES, TRAIN_READS, 9)).astype(np.float32),
        "kmer": rng.integers(0, 66, size=(TRAIN_SITES, TRAIN_READS, 3)).astype(np.int32),
        "y": rng.integers(0, 2, size=TRAIN_SITES).astype(np.float32),
    } for _ in range(n_batches)]


def train_model(config, state, device):
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.train import loop, losses

    model = MILModel(config).to(device)
    model.load_state_dict(state)
    optimizer = loop.make_optimizer(model, TRAIN_LR, TRAIN_WD)
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, optimizer, TRAIN_CLIP)
    return model, step


def run_train_steps(config, state, device, batches):
    """The train steps from ``state`` on ``device``: every step's loss and
    the final parameters (JAX tree layout, numpy)."""
    from m6anet_tpu_torch.models.convert import params_to_jax
    from m6anet_tpu_torch.train import loop

    device = torch.device(device)
    model, step = train_model(config, state, device)
    step_losses = [step(loop.batch_to_device(b, device))[0] for b in batches]
    return torch.stack(step_losses).cpu().numpy(), params_to_jax(model.state_dict())


def param_diffs(a, b):
    """Largest gap by leaf between two parameter trees (paths as keys)."""
    from m6anet_tpu_torch.utils.treeio import flatten_tree

    a, b = flatten_tree(a), flatten_tree(b)
    return {path: float(np.abs(a[path] - b[path]).max()) for path in a}


def check_train_start(config, state, label, batches):
    """Phase 14 for one starting state; returns what the training line
    reports of it."""
    from m6anet_tpu_torch.models.convert import params_to_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.train import losses
    from m6anet_tpu_torch.utils.treeio import flatten_tree

    # the first step, on the card and the CPU, from the same state
    grad_model = MILModel(config)
    grad_model.load_state_dict(state)
    first = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    losses.binary_cross_entropy_loss(grad_model.site_probability(first, train=True), first["y"]).backward()
    grads = flatten_tree(params_to_jax({k: p.grad for k, p in grad_model.named_parameters() if p.grad is not None}))
    (card_loss,), card_params = run_train_steps(config, state, "cuda", batches[:1])
    (cpu_loss,), cpu_params = run_train_steps(config, state, "cpu", batches[:1])
    first_loss_rel = float(abs(card_loss - cpu_loss) / abs(cpu_loss))
    first_err, unresolved = 0.0, 0
    card_params = flatten_tree(card_params)
    for path, want in flatten_tree(cpu_params).items():
        diff = np.abs(card_params[path] - want)
        # no gradient at all (a BatchNorm statistic, a read classifier the
        # site output does not reach) counts as below the threshold
        loose = np.abs(grads.get(path, np.zeros(want.shape))) < TRAIN_UNRESOLVED_GRAD
        if path.endswith(("bn_mean", "bn_var")):
            loose[:] = False
        unresolved += int(loose.sum())
        first_err = max(first_err, float(diff[~loose].max(initial=0.0)))
        if diff[~loose].max(initial=0.0) > TRAIN_FIRST_ATOL or diff[loose].max(initial=0.0) > 2 * TRAIN_LR:
            fail(f"[T1 {label}] first step: {path} off by {diff.max():.3e} (card vs CPU)")
    log(f"[T1 {label}] first step: loss card {card_loss:.9g} CPU {cpu_loss:.9g} (relative {first_loss_rel:.2e}); "
        f"parameters within {first_err:.3e}, {unresolved} elements with |grad| < {TRAIN_UNRESOLVED_GRAD} "
        f"held to {2 * TRAIN_LR}")
    if first_loss_rel > TRAIN_FIRST_LOSS_RTOL:
        fail(f"[T1 {label}] first step: loss off by {first_loss_rel:.3e} relative")

    # twenty steps each side
    card = run_train_steps(config, state, "cuda", batches)
    cpu = run_train_steps(config, state, "cpu", batches)
    if not (np.isfinite(card[0]).all() and np.isfinite(cpu[0]).all()):
        fail(f"[T1 {label}] non-finite losses")
    loss_rel = float(np.max(np.abs(card[0] - cpu[0]) / np.abs(cpu[0])))
    diffs = param_diffs(card[1], cpu[1])
    log(f"[T1 {label}] {len(batches)} steps: losses card {card[0][0]:.6f} -> {card[0][-1]:.6f}, CPU "
        f"{cpu[0][0]:.6f} -> {cpu[0][-1]:.6f}; largest relative loss gap {loss_rel:.3e} "
        f"(tolerance {TRAIN_LOSS_RTOL}); final parameters, largest gap by leaf {diffs}")
    if loss_rel > TRAIN_LOSS_RTOL or max(diffs.values()) > TRAIN_PARAM_ATOL:
        fail(f"[T1 {label}] card and CPU trajectories apart beyond the tolerances")

    # determinism: the card's steps again (the gap by leaf; 0 everywhere
    # means the same bits)
    again = run_train_steps(config, state, "cuda", batches)
    repeat = {"losses_bit_identical": bool(np.array_equal(card[0], again[0])),
              "param_gap_by_leaf": param_diffs(card[1], again[1])}
    log(f"[T1 {label}] the card's {len(batches)} steps again: {repeat}")
    return {"first_step_loss_rel": first_loss_rel, "first_step_param_err": first_err,
            "first_step_unresolved_elements": unresolved, "loss_rel": loss_rel, "param_gap_by_leaf": diffs,
            "card_losses": card[0].tolist(), "cpu_losses": cpu[0].tolist(), "repeat": repeat}


def determinism_probe():
    """Where the card's train steps lose bit-reproducibility: one step's
    forward and gradients twice from one state (the bits of the loss, the
    site probabilities and each gradient leaf), each product of the
    backward alone, ten times twice, and phase 14's 20 steps from the
    released weights twice.  Run in a process of its own, so the cuBLAS
    workspace setting and torch.use_deterministic_algorithms that the
    caller chose hold from the first cuBLAS call.  Prints one JSON line."""
    from m6anet_tpu_torch.models.convert import params_from_jax, params_to_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.train import loop, losses
    from m6anet_tpu_torch.utils.treeio import load_tree
    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS

    import tomllib

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        config = tomllib.load(f)
    state = params_from_jax(load_tree(PRETRAINED_CONFIGS["HCT116_RNA002"][0]))
    batch = loop.batch_to_device(train_batches(0, 1)[0], torch.device("cuda"))

    def forward_backward():
        model = MILModel(config).cuda()
        model.load_state_dict(state)
        pred = model.site_probability(batch, train=True)
        loss = losses.binary_cross_entropy_loss(pred, batch["y"])
        loss.backward()
        grads = params_to_jax({k: p.grad for k, p in model.named_parameters()})
        return loss.detach().cpu().numpy(), pred.detach().cpu().numpy(), grads

    def attempt(fn):
        # under torch.use_deterministic_algorithms an op without a
        # deterministic implementation raises: that is a result too
        try:
            return fn()
        except RuntimeError as err:
            return {"error": str(err)[:300]}

    def step_twice():
        a, b = forward_backward(), forward_backward()
        return {"loss_bit_identical": bool(np.array_equal(a[0], b[0])),
                "pred_bit_identical": bool(np.array_equal(a[1], b[1])),
                "grad_gap_by_leaf": param_diffs(a[2], b[2])}

    report = {"one_step": attempt(step_twice)}
    # the backward's products alone, at their shapes in the step
    rng = np.random.default_rng(1)
    n = TRAIN_SITES * TRAIN_READS
    h0, h1 = (torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)).cuda() for w in (15, 150))
    g1, g2 = (torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)).cuda() for w in (150, 32))
    w2 = torch.from_numpy(rng.normal(size=(32, 150)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(0, 66, size=(n, 3))).cuda()
    g_emb = torch.from_numpy(rng.normal(size=(n, 3, 2)).astype(np.float32)).cuda()

    def emb_grad():
        weight = torch.zeros(66, 2, device="cuda", requires_grad=True)
        torch.nn.functional.embedding(ids, weight).backward(g_emb)
        return weight.grad

    ops = {
        "layer-1 weight gradient (15 x 5120 @ 5120 x 150)": lambda: h0.t() @ g1,
        "layer-2 weight gradient (150 x 5120 @ 5120 x 32)": lambda: h1.t() @ g2,
        "layer-2 input gradient (5120 x 32 @ 32 x 150)": lambda: g2 @ w2,
        "bias gradient (sum over 5120 rows)": lambda: g1.sum(0),
        "embedding backward (15,360 ids into 66 rows)": emb_grad,
    }
    report["ops_bit_identical"] = {
        name: attempt(lambda: all(torch.equal(fn(), fn()) for _ in range(10))) for name, fn in ops.items()
    }

    def steps_twice():
        batches = train_batches(0, TRAIN_STEPS)
        first, second = (run_train_steps(config, state, "cuda", batches) for _ in range(2))
        return {"losses_bit_identical": bool(np.array_equal(first[0], second[0])),
                "param_gap_by_leaf": param_diffs(first[1], second[1])}

    report["steps"] = attempt(steps_twice)
    print(json.dumps({"determinism_probe": report}), flush=True)


def run_determinism_probe(deterministic):
    """determinism_probe() in a fresh process: torch's defaults, or
    torch.use_deterministic_algorithms(True) with CUBLAS_WORKSPACE_CONFIG
    set, as torch's reproducibility notes ask."""
    env = dict(os.environ)
    code = "import chip_smoke; chip_smoke.determinism_probe()"
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        code = "import torch; torch.use_deterministic_algorithms(True); " + code
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        log(proc.stdout[-3000:] + proc.stderr[-3000:])
        fail(f"the determinism probe (deterministic={deterministic}) exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["determinism_probe"]


def time_train_steps(config, state, batches):
    """Median ms per train step and per eval step on the card: CUDA events
    around one step after the L2 flush (time_ms; the flush hides the host's
    launches only while it outlasts them, and a train step launches ~250
    kernels, so this reads host time too), the wall of steps launched back
    to back (one event pair around 2 x len(batches) steps, as a training
    loop runs them), the same with each numpy batch copied in
    (loop.batch_to_device), the kernels and device time a step
    (torch.profiler), and the CPU's step on the chip machine's host (host
    clock)."""
    from m6anet_tpu_torch.train import loop, losses

    model, step = train_model(config, state, "cuda")
    eval_step = loop.make_eval_step(model, losses.binary_cross_entropy_loss)
    on_card = [loop.batch_to_device(b, torch.device("cuda")) for b in batches]
    turns = itertools.cycle(on_card)
    out = {
        "train_step_device_ms": time_ms(lambda: step(next(turns)), reps=50),
        "eval_step_device_ms": time_ms(lambda: eval_step(next(turns)), reps=50),
    }
    for key, fn in (("train_step_ms", lambda b: step(on_card[b])),
                    ("train_step_with_copy_ms", lambda b: step(loop.batch_to_device(batches[b], torch.device("cuda")))),
                    ("eval_step_ms", lambda b: eval_step(on_card[b]))):
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(2 * len(batches)):
                fn(i % len(batches))
            end.record()
            end.synchronize()
            rounds.append(start.elapsed_time(end) / (2 * len(batches)))
        out[key] = statistics.median(rounds)
    out["train_step_profile"] = step_profile(lambda: step(next(turns)))
    out["eval_step_profile"] = step_profile(lambda: eval_step(next(turns)))
    _, cpu_step = train_model(config, state, "cpu")
    cpu_batches = [loop.batch_to_device(b, torch.device("cpu")) for b in batches]
    walls = []
    for b in cpu_batches[:5]:
        t0 = time.perf_counter()
        cpu_step(b)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["cpu_train_step_ms_host_clock"] = statistics.median(walls)
    return out


def step_profile(fn, reps=5):
    """torch.profiler over ``reps`` calls of ``fn``: kernels launched and
    device time a call, and the five kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.count, getattr(e, "device_time_total", 0)) for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0]
    top = sorted(kernels, key=lambda k: -k[2])[:5]
    return {
        "kernels_per_call": sum(k[1] for k in kernels) / reps,
        "device_ms_per_call": sum(k[2] for k in kernels) / reps / 1e3,
        "top_kernels_ms_per_call": {k[0][:70]: k[2] / reps / 1e3 for k in top},
    }


def train_cli(work_dir):
    """Phase 15: the train CLI on tests/data; returns its wall, save_dir and
    per-epoch results."""
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH, TRAIN_CONFIG_TEMPLATE
    from m6anet_tpu_torch.utils.config import dump_toml, load_toml
    from m6anet_tpu_torch.utils.treeio import load_tree

    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=os.path.join(ROOT, "tests", "data"), norm_path=DEFAULT_NORM_PATH)
    cfg_path, save_dir = os.path.join(work_dir, "train.toml"), os.path.join(work_dir, "train_out")
    dump_toml(cfg, cfg_path)
    cmd = [sys.executable, "-m", "m6anet_tpu_torch", "train", "--train_config", cfg_path, "--save_dir", save_dir,
           "--epochs", "2", "--save_per_epoch", "2", "--num_iterations", "1"]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - start
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
        fail(f"train CLI exited {proc.returncode}")
    want = ["avg_loss.npz", "model_states", "pr_auc.npz", "roc_auc.npz", "test_results_avg_loss.json",
            "test_results_pr_auc.json", "test_results_roc_auc.json", "train_info.toml", "train_results.json",
            "val_results.json"]
    if sorted(os.listdir(save_dir)) != want:
        fail(f"train CLI wrote {sorted(os.listdir(save_dir))}, not {want}")
    ckpt = os.path.join(save_dir, "model_states", "2")
    if sorted(os.listdir(ckpt)) != ["meta.json", "model_states.npz", "opt_state.npz"]:
        fail(f"train CLI's checkpoint holds {sorted(os.listdir(ckpt))}")
    with np.load(os.path.join(ckpt, "opt_state.npz")) as data:
        n_leaves = len(data.files)
    tree = load_tree(os.path.join(save_dir, "avg_loss.npz"))
    leaves = sorted(f"{blk}/{leaf}" for blk in tree for leaf in tree[blk])
    if n_leaves != 23 or len(leaves) != 11 or tree["block3"]["w"].shape != (15, 150):
        fail(f"train CLI's files are not in the JAX layout: {n_leaves} optimizer leaves, parameters {leaves}")
    results = {}
    for name in ("train_results.json", "val_results.json", *(f"test_results_{c}.json" for c in
                                                             ("avg_loss", "roc_auc", "pr_auc"))):
        with open(os.path.join(save_dir, name)) as f:
            results[name] = json.load(f)
        if not np.isfinite(results[name]["avg_loss"]).all():
            fail(f"train CLI: non-finite losses in {name}")
    if "There are 57 train sites" not in proc.stdout:
        fail("train CLI did not read the 57 train sites of tests/data")
    return wall, save_dir, results


def compare_outputs(out_a, out_b):
    """Largest per-read, mod_ratio and site gaps between two CLI runs."""
    import pandas as pd

    ki, ks = ["transcript_id", "transcript_position", "read_index"], ["transcript_id", "transcript_position"]
    a_i, b_i = (pd.read_csv(os.path.join(d, "data.indiv_proba.csv")).sort_values(ki).reset_index(drop=True)
                for d in (out_a, out_b))
    a_s, b_s = (pd.read_csv(os.path.join(d, "data.site_proba.csv")).sort_values(ks).reset_index(drop=True)
                for d in (out_a, out_b))
    if not ((a_i[ki].values == b_i[ki].values).all() and (a_s[ks].values == b_s[ks].values).all()):
        fail("two CLI runs differ in their rows")
    return {
        "indiv": float((a_i.probability_modified - b_i.probability_modified).abs().max()),
        "mod_ratio": float((a_s.mod_ratio - b_s.mod_ratio).abs().max()),
        "site": float((a_s.probability_modified - b_s.probability_modified).abs().max()),
    }

# ------------------------------------------------------- models and configs
# phase 16: per read, each mode of cuda_fused (and the cuda backend) against
# the torch modules on the card: f32 as kernel vs plain (P_ATOL), f32x3 and
# bf16 at their accuracy against f32 (PERF.md section 2)
ENGINE_READ_ATOL = {"f32": P_ATOL["f32"], "f32x3": 2e-5, "bf16": BF16_INDIV_ATOL}
# phase 17: a generic config on the card against the CPU
GENERIC_READ_ATOL, GENERIC_SITE_ATOL = 1e-6, 1e-5
# the attention-plus-decoder architecture of tests/test_train.py:304
ATTENTION_DECODER = {"block": [
    {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
    {"block_type": "KmerMultipleEmbedding", "input_channel": 66, "output_channel": 2, "num_neighboring_features": 1},
    {"block_type": "ConcatenateFeatures"},
    {"block_type": "Linear", "input_channel": 15, "output_channel": 32, "activation": "relu", "batch_norm": True},
    {"block_type": "Attention", "input_channel": 32, "hidden_layers": [16, 1], "n_reads_per_site": 20},
    {"block_type": "Linear", "input_channel": 32, "output_channel": 1, "activation": "sigmoid", "batch_norm": False},
]}
# the production encoder (15 -> 150 -> 32) under ProbabilityAttention: a
# KDE-gated-attention site decoder and a noisy-OR read classifier, whose
# per-read probabilities inference reports
PROBABILITY_ATTENTION = {"block": [
    {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
    {"block_type": "KmerMultipleEmbedding", "input_channel": 66, "output_channel": 2, "num_neighboring_features": 1},
    {"block_type": "ConcatenateFeatures"},
    {"block_type": "Linear", "input_channel": 15, "output_channel": 150, "activation": "relu", "batch_norm": True},
    {"block_type": "Linear", "input_channel": 150, "output_channel": 32, "activation": "relu", "batch_norm": False},
    {"block_type": "ProbabilityAttention", "input_channel": 32, "hidden_layers_1": [16], "hidden_layers_2": [8, 1],
     "n_bins": 10, "sigma": 0.5, "n_reads_per_site": 20, "read_classifier": "prod_pooling"},
    {"block_type": "Linear", "input_channel": 160, "output_channel": 1, "activation": "sigmoid", "batch_norm": False},
]}


class LogLines:
    """The engine's log lines, captured in this process: ``inference
    path:``, ``batches dispatched:`` and ``kernel launches:``."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.lines.append(record.getMessage())

        self.lines = []
        logging.getLogger("m6anet_tpu_torch.inference").addHandler(Handler())

    def last(self, prefix):
        for line in reversed(self.lines):
            if line.startswith(prefix):
                return line[len(prefix):].strip()
        fail(f"the engine logged no {prefix!r} line")


def reset_launch_counts():
    """Every kernel wrapper's launch count to 0."""
    from m6anet_tpu_torch.ops import encoder_kernel, fused_infer_kernel, mc_kernel

    fused_infer_kernel.launch_count = 0
    fused_infer_kernel.fused_inference_launch_count = 0
    fused_infer_kernel.site_reduce_launch_count = 0
    for mode in fused_infer_kernel.tc_launch_counts:
        fused_infer_kernel.tc_launch_counts[mode] = 0
    for precision in fused_infer_kernel.wide_launch_counts:
        fused_infer_kernel.wide_launch_counts[precision] = 0
    fused_infer_kernel.grouped_launch_count = 0
    encoder_kernel.launch_count = 0
    encoder_kernel.tail_launch_count = 0
    mc_kernel.launch_count = 0
    mc_kernel.long_launch_count = 0


def read_launch_counts():
    """Every kernel wrapper's launch count, under the names of the engine's
    ``kernel launches:`` line."""
    from m6anet_tpu_torch.ops import encoder_kernel, fused_infer_kernel, mc_kernel

    return {
        "fused_inference_t": fused_infer_kernel.launch_count,
        "fused_read_probability": encoder_kernel.launch_count,
        "read_prob_tail": encoder_kernel.tail_launch_count,
        "site_probability_mc": mc_kernel.launch_count,
        "fused_inference": fused_infer_kernel.fused_inference_launch_count,
        "site_reduce": fused_infer_kernel.site_reduce_launch_count,
        **{f"read_prob_tc_{mode}": n for mode, n in fused_infer_kernel.tc_launch_counts.items()},
        **{f"read_prob_wide_{precision}": n for precision, n in fused_infer_kernel.wide_launch_counts.items()},
        "read_prob_grouped": fused_infer_kernel.grouped_launch_count,
        "site_probability_mc_long": mc_kernel.long_launch_count,
    }


def engine_run(logs, model, dataset, out_dir, threshold, device="cuda", **kw):
    """run_inference in this process with every launch count set to 0 just
    before it and read just after; returns what the run reports."""
    from m6anet_tpu_torch.inference.engine import run_inference

    reset_launch_counts()
    start = time.perf_counter()
    run_inference(model, dataset, out_dir, threshold, device=device, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = read_launch_counts()
    if json.loads(logs.last("kernel launches:")) != launches:
        fail(f"{out_dir}: the engine's launch log disagrees with the counts read after the run")
    return {"wall_s": wall, "path": logs.last("inference path:"), "stages": logs.last("inference stages:"),
            "batches": int(logs.last("batches dispatched:")), "launches": launches}


def hold_outputs(out_dir, ref_dir, threshold, read_atol, site_atol, label, rows=(5595, 101)):
    """One run's CSVs against another's (``inference.outputs.compare_runs``):
    the same rows; per read within ``read_atol``; per site within
    ``site_atol`` + 20 max|dp| over the site's reads (``None``: the reads
    alone); the mod_ratio equal off the threshold.  Returns the gaps."""
    from m6anet_tpu_torch.inference.outputs import compare_runs

    gaps = compare_runs(out_dir, ref_dir, threshold, read_atol, site_atol)
    sites = "not held" if site_atol is None else f"{site_atol} + 20 max|dp| over its reads"
    log(f"[{label}] {gaps} (tolerances: per read {read_atol:.3g}, site {sites})")
    if gaps["want_rows"] != list(rows) or not gaps["ok"]:
        fail(f"[{label}] outside tolerance")
    return gaps


def demo_batch(dataset):
    """The demo's sites packed as the engine packs them on the CPU (one
    batch): the arrays compare() takes, and the SiteBatch."""
    from m6anet_tpu_torch.data.batching import pack_sites
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    (batch,) = pack_sites(dataset.iter_sites(), read_capacity=8192, site_capacity=128)
    return (batch.features, fik.checked_kmer_ids(batch.kmer_ids).ids, batch.offsets, batch.counts), batch


def mode_errors(model, dataset, threshold):
    """Each mode's own error on the demo's reads: its plain version against
    an f64 copy of the model (on the card).  Returns the errors, the
    kernels' parameters and the demo's packed batch."""
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    fp = fik.prepare_fused_params_t(model.cuda())
    batch, site_batch = demo_batch(dataset)
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    n = int(counts.sum())
    with torch.no_grad():
        exact = copy.deepcopy(model).double().per_read_probability({"X": features[:n].double(), "kmer": kmer[:n].long()})
        errors = {mode: float((fik.fused_inference_t_plain(fp, features, kmer, None, offsets, counts, threshold, 20, mode)
                               [0][:n].double() - exact).abs().max()) for mode in ENGINE_READ_ATOL}
    return errors, fp, batch, site_batch


def write_plain_outputs(fp, batch, site_batch, precision, threshold, out_dir):
    """The plain version's outputs on the demo's batch in ``precision``,
    written as the engine writes a run's two CSVs."""
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    with torch.no_grad():
        p, site_p, mod_ratio = (t.cpu().numpy() for t in fik.fused_inference_t_plain(
            fp, features, kmer, None, offsets, counts, threshold, 20, precision))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "data.site_proba.csv"), "w") as f_site, \
            open(os.path.join(out_dir, "data.indiv_proba.csv"), "wb") as f_indiv:
        f_site.write(engine.SITE_HEADER)
        f_indiv.write(engine.INDIV_HEADER.encode())
        engine._write_batch(site_batch, p, site_p, mod_ratio, f_site, f_indiv)
    return out_dir


def check_models(logs, work_dir, full_batch):
    """Phase 16: each released model through the engine on the card, in
    every mode of cuda_fused, through --backend cuda and --backend torch
    (whose step runs the per-read tail's kernel and phase B on the card) and
    the MC method, against the torch modules on the CPU (and HCT116 against
    the golden CSVs); each mode's kernel against its plain version on the
    demo's batch and, in bf16, on the production batch, with the model's
    own weights and threshold.  Returns each run's report by model."""
    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
    from m6anet_tpu_torch.data.dataset import build_dataset
    from m6anet_tpu_torch.models import load_model
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        config = tomllib.load(f)
    runs = {
        "torch cpu": dict(backend="torch", device="cpu"),
        "torch": dict(backend="torch"),
        "f32": dict(backend="cuda_fused", precision="f32"),
        "f32x3": dict(backend="cuda_fused", precision="f32x3"),
        "bf16": dict(backend="cuda_fused", precision="bf16"),
        "cuda f32": dict(backend="cuda", precision="f32"),
        "mc": dict(method="mc", num_iterations=MC_E2E_ITERS),
    }
    # (no f32 phase A at the released widths, nor their tail, shares h1
    # across lane groups: read_prob_grouped stays 0)
    want = {  # the kernels each run must launch, and those it must not
        "torch cpu": ((), ("fused_inference_t", "fused_read_probability", "read_prob_tail", "site_probability_mc",
                           "site_reduce", "read_prob_grouped")),
        "torch": (("read_prob_tail", "site_reduce"), ("fused_inference_t", "fused_read_probability",
                                                      "site_probability_mc", "read_prob_grouped")),
        "f32": (("fused_inference_t", "site_reduce"), ("read_prob_tc_f32x3", "read_prob_tc_bf16", "read_prob_grouped")),
        "f32x3": (("fused_inference_t", "read_prob_tc_f32x3", "site_reduce"), ("read_prob_tc_bf16", "read_prob_grouped")),
        "bf16": (("fused_inference_t", "read_prob_tc_bf16", "site_reduce"), ("read_prob_tc_f32x3", "read_prob_grouped")),
        "cuda f32": (("fused_read_probability",), ("fused_inference_t", "read_prob_tc_f32x3", "read_prob_grouped")),
        "mc": (("fused_inference_t", "read_prob_tc_f32x3", "site_reduce", "site_probability_mc"), ()),
    }
    report = {}
    for name in sorted(PRETRAINED_CONFIGS):
        weights, threshold, norm = PRETRAINED_CONFIGS[name]
        model = load_model(config, weights)
        dataset = build_dataset(os.path.join(ROOT, "tests", "data"), min_reads=20, norm_path=norm, mode="Inference")
        out = {run: os.path.join(work_dir, name, run.replace(" ", "_")) for run in runs}
        entry = {"threshold": threshold, "norm_factors": os.path.basename(norm), "runs": {}, "errors": {}}
        for run, kw in runs.items():
            entry["runs"][run] = rep = engine_run(logs, model, dataset, out[run], threshold, **kw)
            backend = kw.get("backend", "cuda_fused")
            precision = kw.get("precision", "f32" if backend == "torch" else "f32x3")
            device = kw.get("device", "cuda")
            if f"backend={backend} precision={precision}" not in rep["path"] or f"device={device}" not in rep["path"]:
                fail(f"[{name} {run}] ran as {rep['path']!r}")
            launched, idle = want[run]
            if any(rep["launches"][k] < rep["batches"] for k in launched) or any(rep["launches"][k] for k in idle):
                fail(f"[{name} {run}] launches {rep['launches']} in {rep['batches']} batches")
            log(f"[models] {name} {run}: {rep['wall_s']:.3f} s; {rep['path']}; stages {rep['stages']}; "
                f"{rep['batches']} batches; launches {rep['launches']}")
        # each mode's own error on the demo's reads: a model that amplifies
        # rounding more than HCT116_RNA002 (HEK293T_RNA004's f32x3 is 3.3e-5
        # off f64, in either package) widens the per-read tolerance against
        # the torch run to twice that error
        errors, fp, batch, site_batch = mode_errors(model, dataset, threshold)
        read_atol = {mode: max(tol, 2 * errors[mode]) for mode, tol in ENGINE_READ_ATOL.items()}
        entry["mode_error_vs_f64"] = errors
        log(f"[models] {name}: each mode's plain version against f64 on the demo's reads {errors}; per-read "
            f"tolerances against the torch run {read_atol}")
        for run in ("torch", "f32", "cuda f32"):
            entry["errors"][run] = hold_outputs(out[run], out["torch cpu"], threshold, read_atol["f32"], SITE_ATOL,
                                                f"models {name} {run} vs torch on the CPU")
        # the reduced modes: per read against the torch run at the mode's
        # accuracy, and every output against the mode's own plain version
        # at the kernel's tolerance (per site SITE_ATOL + 20 max|dp|)
        for mode in MODES:
            entry["errors"][f"{mode} vs torch"] = hold_outputs(
                out[mode], out["torch cpu"], threshold, read_atol[mode], None,
                f"models {name} {mode} vs torch on the CPU")
            plain_dir = write_plain_outputs(fp, batch, site_batch, mode, threshold, out[mode] + "_plain")
            entry["errors"][f"{mode} vs plain"] = hold_outputs(
                out[mode], plain_dir, threshold, P_ATOL[mode], SITE_ATOL, f"models {name} {mode} vs plain {mode}")
        check_finite(out["mc"], 101, 5595)
        if name == "HCT116_RNA002":
            for run in ("f32", "f32x3"):
                entry["errors"][f"{run} golden"] = check_golden(out[run], label=f"models {name} {run}")
            entry["errors"]["mc golden"] = check_golden(out["mc"], MC_SITE_GOLDEN_ATOL, f"models {name} mc")
        entry["kernel_vs_plain"] = {
            **{f"demo {mode}": compare(fik, fp, batch, f"models {name} demo", mode, threshold, own_share=True)
               for mode in ("f32", "f32x3", "bf16")},
            "production bf16": compare(fik, fp, full_batch, f"models {name} full", "bf16", threshold,
                                       own_share=True),
        }
        report[name] = entry
        shutil.rmtree(os.path.join(work_dir, name), ignore_errors=True)
    return report


def torch_launches(launches, batches, tail, grouped):
    """Whether a torch-backend run on the card launched phase B
    (``site_reduce``, its exact site method) once a batch, the per-read
    tail's kernel (``read_prob_tail``) once a batch where ``tail`` and never
    where not, counted as a plan of lane groups (``read_prob_grouped``)
    where ``grouped``, and nothing else."""
    want = {"site_reduce": batches, "read_prob_tail": batches if tail else 0,
            "read_prob_grouped": batches if grouped else 0}
    return batches > 0 and all(n == want.get(name, 0) for name, n in launches.items())


def time_read_prob_tail(full_batch, peak_flops, peak_bw):
    """Phase 13's entry for the torch backend's per-read tail
    (``encoder_kernel.read_prob_tail``) at the production batch, through the
    signal-only model (9 -> 150 -> 32 -> 1, seeded weights, its BatchNorm's
    running statistics moved off their init): the kernel against the tail's
    modules as the torch step ran them before (the plain version: cuBLAS,
    TF32 off, the eval BatchNorm folded each call), every read within
    P_ATOL["f32"]; the library yardstick, the same three products through
    cuBLAS with the weights folded once; the bound of 2 (9·150 + 150·32 +
    32) FLOP and 40 bytes a real read; ptxas usage; the step's launches of
    the tail and of phase B a batch."""
    import torch.nn.functional as F

    from m6anet_tpu_torch.constants import DEFAULT_READ_THRESHOLD, SIGNAL_MODEL_CONFIG
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.ops import _build
    from m6anet_tpu_torch.ops import encoder_kernel as enc
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.utils.config import load_toml

    model = MILModel(load_toml(SIGNAL_MODEL_CONFIG)).init(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        bn = model.encoder[-2].bn
        bn.running_mean.copy_(torch.rand(bn.running_mean.shape, generator=g) - 0.5)
        bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) + 0.2)
    model = model.cuda()
    tp = enc.tail_params(model)
    if tp is None:
        fail("[tail] the signal-only model's tail was not taken by the kernel")
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in full_batch)
    n_real = int(counts.sum())
    l1, l2 = model.encoder[-2:]
    pool = model.per_read_filter()
    with torch.no_grad():
        x = {"X": features, "kmer": kmer}
        for blk in tp.head:  # the blocks before the tail, as the step runs them
            x = blk(x)
        x = x.reshape(-1, tp.widths.n_in).contiguous()
        (w1, b1), (w2, b2) = l1.folded(), l2.folded()
        w3, b3 = pool.linear.weight, pool.linear.bias

        def kernel():
            return enc.read_prob_tail(tp, x)

        def plain():
            return pool.per_read_prob(l2(l1(x)))

        def library():
            return torch.sigmoid(F.linear(F.relu(F.linear(F.relu(F.linear(x, w1, b1)), w2, b2)), w3, b3)).flatten()

        p, want = kernel(), plain()
        exact = copy.deepcopy(model).double().per_read_probability({"X": features[:n_real].double(),
                                                                      "kmer": kmer[:n_real].long()})
        max_err = float((p - want).abs().max())
        err_f64 = float((p[:n_real].double() - exact).abs().max())
        plain_err_f64 = float((want[:n_real].double() - exact).abs().max())
        if not max_err <= P_ATOL["f32"] or not torch.equal(p, kernel()):
            fail(f"[tail] read_prob_tail against the modules: max |dp| {max_err:.3e} (tolerance {P_ATOL['f32']}), "
                 f"or two launches differ")
        ms, plain_ms, library_ms = time_ms(kernel), time_ms(plain), time_ms(library)
        split = device_split_ms(kernel)
        parent = check_parent_tail(tp, x)
        before = enc.tail_launch_count, fik.site_reduce_launch_count, fik.grouped_launch_count
        step = engine.make_infer_step(model, counts.shape[0], DEFAULT_READ_THRESHOLD, backend="torch")
        step(features, kmer, offsets, counts)
        torch.cuda.synchronize()
        step_launches = {"read_prob_tail": enc.tail_launch_count - before[0],
                         "site_reduce": fik.site_reduce_launch_count - before[1],
                         "read_prob_grouped": fik.grouped_launch_count - before[2]}
    lane_group = enc.tail_lib(tp.widths).lane_group
    if step_launches != {"read_prob_tail": 1, "site_reduce": 1, "read_prob_grouped": 1} or lane_group < 2:
        fail(f"[tail] the torch step on the card launched {step_launches} a batch, the tail's lane groups "
             f"{lane_group} lanes")
    flop_ms = n_real * 2 * (9 * 150 + 150 * 32 + 32) / peak_flops * 1e3
    byte_ms = n_real * (4 * 9 + 4) / peak_bw * 1e3
    ptxas = _build.ptxas_usage(_build.cuda_library("fused_infer", enc.tail_defines(tp.widths)), "read_prob_kernel")
    log(f"[timing tail] read_prob_tail at {x.shape[0]} reads: {ms:.4f} ms, modules {plain_ms:.4f} ms, cuBLAS "
        f"with the weights folded once {library_ms:.4f} ms, bound {max(flop_ms, byte_ms):.4f} ms; max |dp| "
        f"{max_err:.3e} against the modules, {err_f64:.3e} against float64 (the modules' {plain_err_f64:.3e}); "
        f"device time per launch (torch.profiler, ms): {split or 'not measured'}; ptxas {ptxas}; lane groups of "
        f"{lane_group}")
    return {
        "name": "read_prob_tail",
        "route": "cuda",
        "source": "m6anet_tpu_torch/ops/csrc/fused_infer.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the JAX package's xla backend runs these modules",
        "launches": step_launches["read_prob_tail"],
        "max_abs_err": max_err,
        "max_abs_err_vs_f64": err_f64,
        "plain_max_abs_err_vs_f64": plain_err_f64,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": library_ms,
        "library_note": "the tail's three products through cuBLAS (TF32 off), relu and sigmoid, the weights "
                        "folded once",
        "launches_per_batch": step_launches["read_prob_tail"],
        "path": "the torch backend's step on the card: inference --backend auto on the signal-only config "
                "(phase 17), the m6anet_signal.step.exact cell",
        "device_ms": split,
        "read_prob_kernel_ptxas": ptxas,
        "lane_group": lane_group,
        "grouped_launches_per_batch": step_launches["read_prob_grouped"],
        "parent": parent,
    }


def check_generic(logs, work_dir):
    """Phase 17: the signal-only config, a ProbabilityAttention config and
    the signal-only blocks with a tanh last block (seeded weights) through
    inference on the card with backend and precision auto, which must take
    the torch backend and launch phase B once a batch and the per-read
    tail's kernel once a batch (``read_prob_tail``), the tanh config none
    (its blocks run as modules), against the same run on the CPU; the
    signal-only config once more through the CLI (--model_config,
    --model_state_dict); then 20 train steps of the attention-plus-decoder
    architecture, card against CPU."""
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH, DEFAULT_READ_THRESHOLD, SIGNAL_MODEL_CONFIG
    from m6anet_tpu_torch.data.dataset import build_dataset
    from m6anet_tpu_torch.models.convert import params_to_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.utils.config import dump_toml, load_toml
    from m6anet_tpu_torch.utils.treeio import save_tree

    report = {}
    data = os.path.join(ROOT, "tests", "data")
    dataset = build_dataset(data, min_reads=20, norm_path=DEFAULT_NORM_PATH, mode="Inference")
    signal = load_toml(SIGNAL_MODEL_CONFIG)
    tanh = copy.deepcopy(signal)
    tanh["block"][-2]["activation"] = "tanh"
    # name -> (config, whether the tail's kernel takes it, whether its plan
    # shares h1 across lane groups: the signal-only tail's 9 inputs, not the
    # production encoder's 15)
    configs = {"prod_pooling_signal.toml": (signal, True, True),
               "ProbabilityAttention": (PROBABILITY_ATTENTION, True, False),
               "signal, tanh last block": (tanh, False, False)}
    for name, (config, tail, grouped) in configs.items():
        model = MILModel(config).init(torch.Generator().manual_seed(0)).eval()
        out = {device: os.path.join(work_dir, name, device) for device in ("cuda", "cpu")}
        card = engine_run(logs, model, dataset, out["cuda"], DEFAULT_READ_THRESHOLD)  # backend, precision auto
        cpu = engine_run(logs, model, dataset, out["cpu"], DEFAULT_READ_THRESHOLD, device="cpu")
        log(f"[generic] {name}: card {card['wall_s']:.3f} s ({card['path']}; stages {card['stages']}; "
            f"launches {card['launches']}), CPU {cpu['wall_s']:.3f} s ({cpu['path']})")
        if "device=cuda backend=torch precision=f32" not in card["path"] or not torch_launches(
                card["launches"], card["batches"], tail, grouped):
            fail(f"[generic] {name} under auto ran as {card['path']!r} with launches {card['launches']}")
        errs = hold_outputs(out["cuda"], out["cpu"], DEFAULT_READ_THRESHOLD, GENERIC_READ_ATOL, GENERIC_SITE_ATOL,
                            f"generic {name} card vs CPU")
        report[name] = {"card": card, "cpu": cpu, "card_vs_cpu": errs}
        if name == "prod_pooling_signal.toml":
            weights = os.path.join(work_dir, "signal.npz")
            save_tree(weights, params_to_jax(model.state_dict()))
            cfg_path = os.path.join(work_dir, "signal.toml")
            dump_toml(config, cfg_path)
            cli_out = os.path.join(work_dir, "signal_cli")
            wall, path, batches, launches = run_cli("HCT116_RNA002", cli_out, [
                "--model_config", cfg_path, "--model_state_dict", weights, "--norm_path", DEFAULT_NORM_PATH,
                "--read_proba_threshold", str(DEFAULT_READ_THRESHOLD)])
            if "device=cuda backend=torch precision=f32" not in path or not torch_launches(launches, batches, True,
                                                                                              True):
                fail(f"[generic] the CLI ran the signal-only config as {path!r} with launches {launches}")
            report[name]["cli"] = {"wall_s": wall, "path": path, "launches": launches,
                                   "vs_cpu": hold_outputs(cli_out, out["cpu"], DEFAULT_READ_THRESHOLD,
                                                          GENERIC_READ_ATOL, GENERIC_SITE_ATOL,
                                                          "generic signal CLI card vs CPU")}
    state = MILModel(ATTENTION_DECODER).init(torch.Generator().manual_seed(0)).state_dict()
    report["train attention + decoder"] = check_train_start(
        ATTENTION_DECODER, state, "attention + decoder", train_batches(1, TRAIN_STEPS))
    shutil.rmtree(work_dir, ignore_errors=True)
    return report


# ------------------------------------------------- columnar store, shards
# phase 18: a store of four production batches' worth of sites, read counts
# from scripts/_sweep.production_batch's HEK293T-shaped law
COLUMNAR_SITES = 4 * 16384
# the JAX package's bound between its columnar and data.json runs
# (tests/test_columnar.py): the store holds f32 reads and normalises in f32,
# data.json's decimals are normalised in f64
COLUMNAR_JSON_READ_ATOL = 5e-5
STAGE_RE = re.compile(r"([\w+]+)=([\d.]+)s/(\d+)x")


def stage_seconds(stages):
    """``inference stages:`` as {stage: seconds}."""
    return {name: float(sec) for name, sec, _ in STAGE_RE.findall(stages)}


def demo_sites():
    from m6anet_tpu_torch.data.dataset import SiteDataset

    raw = SiteDataset(os.path.join(ROOT, "tests", "data"), min_reads=0, norm_path=None)
    raw.norm_dict = None
    return list(raw.iter_sites())


def write_store(root, sites):
    """A columnar store of the given (raw) sites, by the port's writer."""
    from m6anet_tpu_torch.data.columnar import ColumnarWriter

    writer = ColumnarWriter(root, 3)
    for site in sites:
        writer.append_site(site.tx_id, site.tx_pos, site.sequence, site.features, site.read_ids)
    writer.finalize()
    return root


def write_production_store(root, seed=0):
    """COLUMNAR_SITES sites of seeded raw reads: read counts
    clip(gamma(2, 30), 20, 1000) as in _sweep.production_batch, the demo's
    sequence contexts in turn (real k-mers), each read its k-mers' norm
    factors' mean + std x N(0, 1), so the normalised reads are N(0, 1).
    Returns (sites, reads, bytes, seconds)."""
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH
    from m6anet_tpu_torch.data.columnar import ColumnarWriter
    from m6anet_tpu_torch.data.norm import load_norm_factors, site_norm_vectors

    start = time.perf_counter()
    seqs = [site.sequence for site in demo_sites()]
    norm = load_norm_factors(DEFAULT_NORM_PATH)
    vectors = {seq: tuple(v.astype(np.float32) for v in site_norm_vectors(norm, seq, 3)) for seq in set(seqs)}
    rng = np.random.default_rng(seed)
    counts = np.clip(rng.gamma(2.0, 30.0, size=COLUMNAR_SITES), 20, 1000).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    noise = rng.standard_normal(size=(int(bounds[-1]), 9), dtype=np.float32)
    writer = ColumnarWriter(root, 3)
    for i in range(COLUMNAR_SITES):
        seq = seqs[i % len(seqs)]
        mean, std = vectors[seq]
        lo, hi = bounds[i], bounds[i + 1]
        writer.append_site(f"CHIP{i // 256:05d}", 100 + 10 * (i % 256), seq, mean + std * noise[lo:hi],
                           np.arange(lo, hi, dtype=np.int64))
    writer.finalize()
    size = sum(os.path.getsize(os.path.join(root, "columnar", f)) for f in os.listdir(os.path.join(root, "columnar")))
    return COLUMNAR_SITES, int(bounds[-1]), size, time.perf_counter() - start


class GenericFeed:
    """A dataset's sites without its ``iter_packed``: the engine then packs
    them with ``pack_sites``, as for data.json."""

    def __init__(self, dataset):
        self.dataset, self.max_site_reads = dataset, dataset.max_site_reads

    def __len__(self):
        return len(self.dataset)

    def iter_sites(self, n_threads=1):
        return self.dataset.iter_sites(n_threads)


def same_csvs(a, b, suffix=""):
    names = ["data.site_proba.csv"] + (["data.indiv_proba.csv"] if os.path.exists(
        os.path.join(b, "data.indiv_proba.csv")) else [])
    for name in names:
        with open(os.path.join(a, name + suffix), "rb") as f, open(os.path.join(b, name), "rb") as g:
            if f.read() != g.read():
                return False
    return True


def feed_seconds(batches):
    """Host seconds to make every batch of a feed, with the engine's k-mer
    check: (seconds, batches, sites)."""
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    start, n, sites = time.perf_counter(), 0, 0
    for batch in batches:
        fik.checked_kmer_ids(batch.kmer_ids)
        n, sites = n + 1, sites + batch.n_sites
    return time.perf_counter() - start, n, sites


def check_columnar(logs, work_dir):
    """Phase 18: the columnar store at four production batches' size through
    the CLI (--columnar, auto = cuda_fused f32x3; and --site_proba_method
    mc), each kernel of the path once a batch; iter_packed's first batch the
    same bits as pack_sites(iter_sites())'s; both feeds timed alone on the
    host and through the engine, whose generic-feed CSVs must be the
    columnar run's bytes; on the demo, --columnar against data.json."""
    from m6anet_tpu_torch.constants import DEFAULT_MIN_READS, DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
    from m6anet_tpu_torch.data.batching import pack_sites
    from m6anet_tpu_torch.data.columnar import ColumnarSiteDataset
    from m6anet_tpu_torch.models import load_model
    from m6anet_tpu_torch.utils.config import load_toml

    report = {}
    store = os.path.join(work_dir, "store")
    n_sites, n_reads, size, write_s = write_production_store(store)
    report["store"] = {"sites": n_sites, "reads": n_reads, "bytes": size, "write_s": write_s}
    log(f"[columnar] store: {n_sites} sites, {n_reads} reads, {size} bytes, written in {write_s:.3f} s")
    _, threshold, norm = PRETRAINED_CONFIGS["HCT116_RNA002"]
    ds = ColumnarSiteDataset(store, min_reads=DEFAULT_MIN_READS, norm_path=norm)
    read_cap, site_cap = 1048576, 16384  # the CLI's defaults on the card

    # iter_packed's first batch against pack_sites over the same sites
    got = next(ds.iter_packed(0, None, read_cap, site_cap))
    want = next(pack_sites(ds.iter_sites(), read_capacity=read_cap, site_capacity=site_cap))
    fields = ("features", "kmer_ids", "site_ids", "offsets", "counts", "global_ids")
    same = {f: bool(getattr(got, f).dtype == getattr(want, f).dtype and np.array_equal(getattr(got, f), getattr(want, f)))
            for f in fields}
    same["sites"] = [(s.tx_id, s.tx_pos) for s in got.sites] == [(s.tx_id, s.tx_pos) for s in want.sites]
    log(f"[columnar] iter_packed's first batch ({got.n_sites} sites, {got.n_reads} reads) against "
        f"pack_sites(iter_sites()), the same bits: {same}")
    if not all(same.values()):
        fail("iter_packed's first batch is not pack_sites(iter_sites())'s")
    report["first_batch"] = {"sites": got.n_sites, "reads": got.n_reads, "same_bits": same}
    del got, want

    # both feeds alone on the host
    feeds = {}
    for name, batches in (("columnar", ds.iter_packed(0, None, read_cap, site_cap)),
                          ("generic", pack_sites(ds.iter_sites(), read_capacity=read_cap, site_capacity=site_cap))):
        sec, n_batches, sites = feed_seconds(batches)
        feeds[name] = {"seconds": sec, "batches": n_batches, "sites": sites, "sites_per_s": sites / sec}
    log(f"[columnar] the feeds alone on the host (batches made and k-mer-checked): {feeds}")
    report["feeds_alone"] = feeds

    # the CLI, both methods; then the generic feed through the engine
    runs = {}
    for method, extra in (("exact", []), ("mc", ["--site_proba_method", "mc"])):
        out = os.path.join(work_dir, f"cli_{method}")
        wall, path, n_batches, launches = run_cli("HCT116_RNA002", out, ["--columnar", *extra], input_dir=store)
        stages = stage_seconds(path.split("; stages ")[1])
        want_launches = {k: 0 for k in launches}
        want_launches.update(fused_inference_t=n_batches, read_prob_tc_f32x3=n_batches, site_reduce=n_batches)
        if method == "mc":
            want_launches["site_probability_mc"] = n_batches
        log(f"[columnar] --columnar {method}: {wall:.3f} s wall; {path}; {n_batches} batches; launches {launches}")
        if "backend=cuda_fused" not in path or "precision=f32x3" not in path or launches != want_launches:
            fail(f"--columnar {method} ran as {path!r} with launches {launches}, not one of each of "
                 f"{[k for k, v in want_launches.items() if v]} a batch")
        runs[method] = {"wall_s": wall, "path": path, "batches": n_batches, "launches": launches,
                        "stages_s": stages, "sites_per_s": n_sites / wall}
    # both feeds through the engine in this process (start-up paid), the
    # generic one's CSVs the --columnar run's bytes; the dispatch stage by part
    model = load_model(load_toml(DEFAULT_MODEL_CONFIG), PRETRAINED_CONFIGS["HCT116_RNA002"][0])
    for label, dataset in (("generic", GenericFeed(ds)), ("columnar", ds)):
        out = os.path.join(work_dir, f"engine_{label}")
        run = engine_run(logs, model, dataset, out, threshold, read_capacity=read_cap, site_capacity=site_cap)
        run.update(stages_s=stage_seconds(run["stages"]), sites_per_s=n_sites / run["wall_s"],
                   byte_identical=same_csvs(out, os.path.join(work_dir, "cli_exact")))
        log(f"[columnar] the {label} feed through the engine in this process: {run['wall_s']:.3f} s; stages "
            f"{run['stages']}; launches {run['launches']}; CSVs the --columnar CLI run's bytes: "
            f"{run['byte_identical']}")
        if not run["byte_identical"]:
            fail(f"the {label} feed's CSVs are not the --columnar CLI run's bytes")
        runs[f"{label} feed, exact, in process"] = run
        shutil.rmtree(out)
    report["runs"] = runs
    report["dispatch_parts_s"] = dispatch_parts(model, next(ds.iter_packed(0, None, read_cap, site_cap)),
                                                threshold, site_cap)
    log(f"[columnar] one production batch's dispatch by part (host clock, synchronised, median of 3): "
        f"{report['dispatch_parts_s']}")
    for name in os.listdir(work_dir):
        if name.startswith("cli_"):
            shutil.rmtree(os.path.join(work_dir, name))

    # on the demo: --columnar (the demo's data.json written as a store)
    # against data.json, on the card
    demo_store = write_store(os.path.join(work_dir, "demo_store"), demo_sites())
    out_col, out_json = os.path.join(work_dir, "demo_columnar"), os.path.join(work_dir, "demo_json")
    col = cli_in_process(logs, out_col, "--columnar", input_dir=demo_store)
    cli_in_process(logs, out_json, input_dir=os.path.join(ROOT, "tests", "data"))
    gaps = hold_outputs(out_col, out_json, threshold, COLUMNAR_JSON_READ_ATOL, None,
                        "columnar demo: --columnar vs data.json on the card")
    check_golden(out_col, label="columnar demo")
    report["demo"] = {"columnar": col, "columnar_vs_json": gaps, "byte_identical": same_csvs(out_col, out_json)}
    return report, demo_store


def cli_in_process(logs, out, *flags, input_dir):
    """The inference CLI's main() in this process on the card, every launch
    count set to 0 just before it; returns its wall, launches, path, stages
    and batches."""
    from m6anet_tpu_torch.cli import main as cli_main

    reset_launch_counts()
    start = time.perf_counter()
    cli_main(["inference", "--input_dir", *([input_dir] if isinstance(input_dir, str) else input_dir),
              "--out_dir", out, *flags])
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - start, "launches": read_launch_counts(),
            "path": logs.last("inference path:"), "stages": logs.last("inference stages:"),
            "batches": int(logs.last("batches dispatched:"))}


def dispatch_parts(model, batch, threshold, site_cap, reps=3):
    """One production-size batch's dispatch stage by part, as the engine
    runs it (cuda_fused, f32x3): the h2d copies of its arrays from pageable
    memory, the step, and the outputs' copy back to pinned memory and its
    wait.  Host clock around each part ending in a synchronise; medians of
    ``reps``."""
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    model = model.to("cuda").eval()
    step = engine.make_infer_step(model, site_cap, threshold, backend="cuda_fused", precision="f32x3")
    host_kmer = fik.checked_kmer_ids(batch.kmer_ids)
    arrays = (batch.features, host_kmer.ids, batch.offsets, batch.counts)
    parts = {"h2d": [], "step": [], "copy_back": []}
    with torch.no_grad():
        for _ in range(reps + 1):  # the first round warms up
            t0 = time.perf_counter()
            tensors = [torch.from_numpy(a).to("cuda") for a in arrays]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outputs = step(*tensors, host_sites=(batch.offsets, batch.counts), host_kmer_ids=host_kmer)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            engine._PendingBatch(batch, outputs, torch.device("cuda")).fetch()
            t3 = time.perf_counter()
            for name, sec in (("h2d", t1 - t0), ("step", t2 - t1), ("copy_back", t3 - t2)):
                parts[name].append(sec)
    out = {name: statistics.median(v[1:]) for name, v in parts.items()}
    out["h2d_bytes"] = int(sum(a.nbytes for a in arrays))
    return out


def launch_ranks(argv, world, timeout=300, env_extra=None):
    """``argv`` as ``world`` ranks of a job on this machine (the launcher's
    env:// variables set by hand, a free port); returns [(code, stdout,
    stderr)] by rank.  Every rank shares card 0."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port), **(env_extra or {}))
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    return procs


def wait_ranks(procs, label, timeout=300):
    results = []
    deadline = time.perf_counter() + timeout
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            fail(f"{label}: a rank outlasted {timeout} s")
        results.append((proc.returncode, out, err))
    for rank, (code, out, err) in enumerate(results):
        if code != 0:
            log(out[-3000:] + err[-3000:])
            fail(f"{label}: rank {rank} exited {code}")
    return results


# phase 19's train steps: phase 14's batches, the last cut to 255 sites and
# wrap-padded to 256 as TrainLoader(pad_to_multiple=2) pads it
def dp_batches():
    batches = train_batches(0, TRAIN_STEPS)
    for b in batches:
        b["mask"] = np.ones(TRAIN_SITES, np.float32)
    last = batches[-1]
    for key in ("X", "kmer", "y"):
        last[key][-1] = last[key][0]
    last["mask"][-1] = 0.0
    return batches


def dp_train_rank(out_path):
    """One rank of phase 19's data-parallel train job on the card (run by
    check_shards in a process of its own, with the launcher's variables
    and deterministic algorithms): phase 14's steps from the released HCT116
    weights through train.loop.make_train_step over the job; a job of one
    rank also takes the steps without the job.  Rank 0 saves the losses and
    final parameters (npz)."""
    import tomllib

    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
    from m6anet_tpu_torch.models.convert import params_from_jax, params_to_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.parallel.group import DataParallel, start_job
    from m6anet_tpu_torch.train import loop, losses
    from m6anet_tpu_torch.utils.logging import get_logger
    from m6anet_tpu_torch.utils.treeio import flatten_tree, load_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        config = tomllib.load(f)
    state = params_from_jax(load_tree(PRETRAINED_CONFIGS["HCT116_RNA002"][0]))
    job = start_job(torch.device("cuda"), device_collectives=True, log=get_logger("chip_smoke"))
    batches = dp_batches()

    def steps(data_parallel):
        model = MILModel(config).to(job.device)
        model.load_state_dict(state)
        step = loop.make_train_step(model, losses.binary_cross_entropy_loss,
                                    loop.make_optimizer(model, TRAIN_LR, TRAIN_WD), TRAIN_CLIP, data_parallel)
        step_losses = [step(loop.batch_to_device(b, job.device))[0] for b in batches]
        return torch.stack(step_losses).cpu().numpy(), flatten_tree(params_to_jax(model.state_dict()))

    on = steps(DataParallel(job))
    result = {"on_losses": on[0], **{f"on/{k}": v for k, v in on[1].items()}}
    if job.world_size == 1:
        off = steps(None)
        result.update({"off_losses": off[0], **{f"off/{k}": v for k, v in off[1].items()}})
    if job.rank == 0:
        np.savez(out_path, backend=job.backend, **result)
    job.barrier()
    job.close()


def check_shards(logs, work_dir, demo_store):
    """Phase 19, on the one card: host shards (--host_shard 0 2 and 1 2,
    then a merge), --distributed with two ranks sharing the card and
    --concat_shards over two stores, each merged output the one-process
    run's bytes, exact and MC; then train --use_mesh on's step with one rank
    (the bits of the step without the job) and two ranks sharing the card
    (phase 14's tolerances against one rank).  The four jobs (two
    inference, two train) run at once, beside the in-process runs."""
    from m6anet_tpu_torch.data.columnar import ColumnarSiteDataset
    from m6anet_tpu_torch.inference.engine import merge_host_shards

    report = {}
    demo = os.path.join(ROOT, "tests", "data")
    mc = ["--site_proba_method", "mc"]
    start = time.perf_counter()
    jobs = {}
    for label, flags, input_dir in (("json exact", [], demo), ("columnar mc", ["--columnar", *mc], demo_store)):
        out = os.path.join(work_dir, "distributed", label.replace(" ", "_"))
        argv = [sys.executable, "-m", "m6anet_tpu_torch", "inference", "--input_dir", input_dir, "--out_dir", out,
                *flags, "--distributed"]
        jobs[f"--distributed {label}"] = (out, label, launch_ranks(argv, 2))
    code = "import torch; torch.use_deterministic_algorithms(True); import sys, chip_smoke; chip_smoke.dp_train_rank(sys.argv[1])"
    for world in (1, 2):
        path = os.path.join(work_dir, f"dp{world}.npz")
        jobs[f"train --use_mesh on, {world} rank(s)"] = (path, world, launch_ranks(
            [sys.executable, "-c", code, path], world, env_extra={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}))

    # the one-process runs: the demo store, exact and MC, and data.json
    ref = {}
    for label, flags, input_dir in (("columnar exact", ["--columnar"], demo_store),
                                     ("columnar mc", ["--columnar", *mc], demo_store),
                                     ("json exact", [], demo)):
        ref[label] = os.path.join(work_dir, "one", label.replace(" ", "_"))
        report.setdefault("one_process", {})[label] = cli_in_process(logs, ref[label], *flags, input_dir=input_dir)

    # --host_shard 0 2 and 1 2, then the merge, in this process
    for label, flags in (("columnar exact", ["--columnar"]), ("columnar mc", ["--columnar", *mc])):
        out = os.path.join(work_dir, "host_shard", label.replace(" ", "_"))
        runs = [cli_in_process(logs, out, *flags, "--host_shard", str(h), "2", input_dir=demo_store)
                for h in range(2)]
        merge_host_shards(out, 2)
        identical = same_csvs(out, ref[label])
        log(f"[shards] --host_shard 0 2 and 1 2 {label}: {[r['wall_s'] for r in runs]} s, launches "
            f"{[r['launches'] for r in runs]}; merged CSVs the one-process bytes: {identical}")
        if not identical or not all(r["launches"]["fused_inference_t"] == 1 for r in runs):
            fail(f"--host_shard {label}: merged CSVs differ from the one-process run, or a shard did not launch")
        report.setdefault("host_shard", {})[label] = {"walls_s": [r["wall_s"] for r in runs],
                                                      "byte_identical": identical}

    # --concat_shards over two stores: the demo store's sites cut in two
    whole = ColumnarSiteDataset(demo_store, min_reads=0, compute_norm=False)
    sites = list(whole.iter_sites())
    half = len(sites) // 2
    parts = [write_store(os.path.join(work_dir, f"part{i}"), chunk) for i, chunk in enumerate((sites[:half], sites[half:]))]
    out = os.path.join(work_dir, "concat")
    run = cli_in_process(logs, out, "--columnar", "--concat_shards", input_dir=parts)
    identical = same_csvs(out, ref["columnar exact"])
    log(f"[shards] --concat_shards --columnar over two stores ({half} + {len(sites) - half} sites): "
        f"{run['wall_s']:.6f} s, launches {run['launches']}; CSVs the one-store bytes: {identical}")
    if not identical:
        fail("--concat_shards: the CSVs are not the one-store run's bytes")
    report["concat_shards"] = {"wall_s": run["wall_s"], "byte_identical": identical}

    # the jobs
    train = {}
    for name, (target, what, procs) in jobs.items():
        results = wait_ranks(procs, name)
        if name.startswith("train"):
            with np.load(target) as data:
                train[what] = {k: data[k] for k in data.files}
            continue
        backends = [m.group(1) if m else None for m in (re.search(r"backend (\w+)", err) for _, _, err in results)]
        identical = same_csvs(target, ref[what])
        log(f"[shards] --distributed {what}: two ranks on card 0, backend {backends}; merged CSVs the "
            f"one-process bytes: {identical}")
        if not identical:
            fail(f"--distributed {what}: the merged CSVs are not the one-process run's bytes")
        report.setdefault("distributed", {})[what] = {"ranks": 2, "byte_identical": identical, "backends": backends}
    report["jobs_wall_s"] = time.perf_counter() - start
    one, two = train[1], train[2]
    leaves = [k[3:] for k in one if k.startswith("on/")]
    one_bits = bool(np.array_equal(one["on_losses"], one["off_losses"])) and all(
        np.array_equal(one[f"on/{k}"], one[f"off/{k}"]) for k in leaves)
    first_rel = float(abs(two["on_losses"][0] - one["on_losses"][0]) / abs(one["on_losses"][0]))
    loss_rel = float(np.max(np.abs(two["on_losses"] - one["on_losses"]) / np.abs(one["on_losses"])))
    gaps = {k: float(np.abs(two[f"on/{k}"] - one[f"on/{k}"]).max()) for k in leaves}
    report["train"] = {
        "steps": TRAIN_STEPS, "sites": TRAIN_SITES, "last_batch_valid": TRAIN_SITES - 1,
        "one_rank_backend": str(one["backend"]), "two_rank_backend": str(two["backend"]),
        "one_rank_on_equals_off_bits": one_bits, "two_vs_one_first_loss_rel": first_rel,
        "two_vs_one_loss_rel": loss_rel, "two_vs_one_param_gap_by_leaf": gaps,
    }
    log(f"[shards] train --use_mesh on: {report['train']}; the four jobs and the in-process runs "
        f"{report['jobs_wall_s']:.3f} s wall")
    if not one_bits:
        fail("train --use_mesh on with one rank is not the bits of the step without the job")
    if first_rel > TRAIN_FIRST_LOSS_RTOL or loss_rel > TRAIN_LOSS_RTOL or max(gaps.values()) > TRAIN_PARAM_ATOL:
        fail("train --use_mesh on with two ranks is outside phase 14's tolerances of one rank")
    shutil.rmtree(work_dir, ignore_errors=True)
    return report

# ------------------------------------------------------------- pipeline
# phase 20's full-size input: the demo eventalign.txt this many times, each
# copy's contigs renamed (2.0 MB a copy: at least 1 GiB)
PIPELINE_COPIES = 512
PIPELINE_MAX_PROCESSES = 16
NORM_RTOL = 1e-9


def host_cpu():
    """The host CPU (its model name, or vendor, family and model number
    where the name is not given) and the cores this process may use:
    dataprep is the host's work, so its rates are the host's."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
            if not line.strip():
                break
    name = fields.get("model name", "unknown")
    if name == "unknown":
        name = (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} model "
                f"{fields.get('model', '?')} (no model name given)")
    return name, len(os.sched_getaffinity(0))


def port_cli(label, *argv, timeout=600):
    """``python -m m6anet_tpu_torch <argv>`` in a fresh process, as a user
    runs it; fails the run if it exits nonzero.  Returns (wall, process)."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "m6anet_tpu_torch", *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - start
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
        fail(f"{label}: m6anet_tpu_torch {argv[0]} exited {proc.returncode}")
    return wall, proc


def check_dataprep_golden(out_dir):
    """The port's dataprep output against tests/data's goldens, as the JAX
    suite holds its own (tests/test_dataprep.py): eventalign.index as a
    sorted frame, data.info's sites and read counts, each site's k-mer
    context, reads (sorted: the reference's read order differs) and
    features."""
    import pandas as pd

    data = os.path.join(ROOT, "tests", "data")
    index = [pd.read_csv(os.path.join(d, "eventalign.index")).sort_values(["transcript_id", "read_index"])
             .reset_index(drop=True) for d in (out_dir, data)]
    if not index[0].equals(index[1]):
        fail("pipeline: eventalign.index differs from the golden")
    keys = ["transcript_id", "transcript_position"]
    got, want = (pd.read_csv(os.path.join(d, "data.info")).sort_values(keys).reset_index(drop=True)
                 for d in (out_dir, data))
    if len(got) != len(want) or not all((got[c].values == want[c].values).all() for c in (*keys, "n_reads")):
        fail("pipeline: data.info's sites or read counts differ from the golden")

    def payload(root, row):
        with open(os.path.join(root, "data.json"), "rb") as f:
            f.seek(row.start)
            (kmer, rows), = json.loads(f.read(row.end - row.start))[row.transcript_id][
                str(row.transcript_position)].items()
        rows = np.asarray(rows)
        order = np.argsort(rows[:, -1], kind="stable")
        return kmer, rows[order]

    worst = 0.0
    for g, w in zip(got.itertuples(), want.itertuples()):
        (kg, rg), (kw, rw) = payload(out_dir, g), payload(data, w)
        if kg != kw or rg.shape != rw.shape or not np.array_equal(rg[:, -1], rw[:, -1]):
            fail(f"pipeline: site {g.transcript_id}:{g.transcript_position}'s context or reads differ")
        if not np.allclose(rg[:, :-1], rw[:, :-1], rtol=1e-7, atol=0):
            fail(f"pipeline: site {g.transcript_id}:{g.transcript_position}'s features differ")
        worst = max(worst, float(np.abs(rg[:, :-1] - rw[:, :-1]).max(initial=0.0)))
    return {"sites": len(got), "reads": int(got.n_reads.sum()), "feature_max_abs_err": worst}


def write_copies(path, copies):
    """``copies`` copies of the demo eventalign.txt under one header, the
    82 contigs of copy k renamed ``<contig>_c<k>``; returns the bytes."""
    with open(os.path.join(ROOT, "tests", "data", "eventalign.txt"), "rb") as f:
        header, body = f.readline(), f.read()
    contigs = sorted({line.split(b"\t", 1)[0] for line in body.splitlines()})
    # one %-template of the body: copy k is one C-level substitution
    template = b"\n".join(b"%(" + str(contigs.index(line.split(b"\t", 1)[0])).encode() + b")s\t"
                          + line.split(b"\t", 1)[1].replace(b"%", b"%%") for line in body.splitlines()) + b"\n"
    with open(path, "wb") as out:
        out.write(header)
        for k in range(copies):
            out.write(template % {str(i).encode(): c + b"_c%d" % k for i, c in enumerate(contigs)})
    return os.path.getsize(path), len(contigs)


def same_tree(a, b):
    """The relative paths of the files under ``a`` and ``b`` whose bytes
    differ (or that only one holds)."""
    files = {d: sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs) for d in (a, b)}
    differ = sorted(set(files[a]) ^ set(files[b]))
    for name in sorted(set(files[a]) & set(files[b])):
        with open(os.path.join(a, name), "rb") as f, open(os.path.join(b, name), "rb") as g:
            while True:
                x, y = f.read(1 << 24), g.read(1 << 24)
                if x != y:
                    differ.append(name)
                    break
                if not x:
                    break
    return differ


def check_pipeline(logs, work_dir, card):
    """Phase 20: eventalign.txt to m6A calls with the port alone.  The demo
    through the dataprep CLI (against the goldens), inference on the card
    over it (the golden CSVs) and --columnar (against the data.json run);
    compute_norm_factors over its labelled sites and train on the card
    with them; then a 1 GiB eventalign through dataprep at N processes
    and at 1 (the same bytes), two host shards, inference --columnar on
    the card and --concat_shards over the shards (the one-store bytes)."""
    import pandas as pd

    from m6anet_tpu_torch import native
    from m6anet_tpu_torch.constants import PRETRAINED_CONFIGS, TRAIN_CONFIG_TEMPLATE
    from m6anet_tpu_torch.data.norm import compute_norm_dict, load_norm_factors
    from m6anet_tpu_torch.utils.config import dump_toml, load_toml

    phase_start = time.perf_counter()
    if native.get_lib() is None:
        fail("pipeline: the port's native library does not build or load (a dataprep timing on the numpy "
             "fallback would say nothing)")
    cpu_model, cores = host_cpu()
    host = {"cpu": cpu_model, "cores": cores, "card": card}
    report = {"host": host}
    log(f"[pipeline] host CPU {cpu_model}, {cores} cores; card {card}")
    threshold = PRETRAINED_CONFIGS["HCT116_RNA002"][1]
    data = os.path.join(ROOT, "tests", "data")

    # ---- the demo: dataprep, inference (data.json and --columnar)
    demo = os.path.join(work_dir, "demo")
    wall, _ = port_cli("pipeline demo dataprep", "dataprep", "--eventalign", os.path.join(data, "eventalign.txt"),
                       "--out_dir", demo, "--min_segment_count", "1", "--format", "both", "--n_processes", "2")
    golden = check_dataprep_golden(demo)
    log(f"[pipeline] demo dataprep: {wall:.3f} s wall; eventalign.index, data.info and data.json the goldens' "
        f"({golden})")
    runs = {}
    for label, flags in (("data.json", []), ("--columnar", ["--columnar"])):
        out = os.path.join(work_dir, "demo_" + label.strip("-").replace(".", "_"))
        run = cli_in_process(logs, out, *flags, input_dir=demo)
        log(f"[pipeline] demo inference ({label}) on the card: {run['wall_s']:.3f} s wall; {run['path']}; stages "
            f"{run['stages']}; {run['batches']} batches; kernel launches {run['launches']}")
        if ("backend=cuda_fused" not in run["path"] or "precision=f32x3" not in run["path"]
                or run["launches"]["read_prob_tc_f32x3"] < 1 or run["launches"]["site_reduce"] < 1):
            fail(f"pipeline demo inference ({label}) ran as {run['path']!r} with launches {run['launches']}")
        runs[label] = dict(run, out=out)
    runs["data.json"]["golden_max_errors"] = check_golden(runs["data.json"]["out"], label="pipeline demo")
    runs["--columnar"]["vs_data_json"] = hold_outputs(
        runs["--columnar"]["out"], runs["data.json"]["out"], threshold, COLUMNAR_JSON_READ_ATOL, None,
        "pipeline demo: --columnar vs data.json on the card")
    report["demo"] = {"dataprep_wall_s": wall, "dataprep_vs_golden": golden,
                      "inference": {k: {kk: vv for kk, vv in v.items() if kk != "out"} for k, v in runs.items()}}

    # ---- norm factors and train.  tests/data/data.info.labelled's offsets
    # point into the reference's data.json, so its labels go onto the
    # port's own data.info
    info = pd.read_csv(os.path.join(demo, "data.info"))
    labels = pd.read_csv(os.path.join(data, "data.info.labelled"))
    keys = ["transcript_id", "transcript_position"]
    labelled = info.merge(labels[[*keys, "modification_status", "set_type"]], on=keys, how="inner")
    if len(labelled) != len(labels):
        fail("pipeline: the labelled sites are not all in the port's data.info")
    labelled.to_csv(os.path.join(demo, "data.info.labelled"), index=False)
    norm_dir = os.path.join(demo, "norm")
    npz = os.path.join(norm_dir, "norm_dict_nanopolish.npz")
    import importlib.util

    if importlib.util.find_spec("joblib") is not None:
        norm_wall, _ = port_cli("pipeline compute_norm_factors", "compute_norm_factors", "--input_dir", demo,
                                "--out_dir", norm_dir)
        written = sorted(os.listdir(norm_dir))
        if written != ["norm_dict_nanopolish.joblib", "norm_dict_nanopolish.npz"]:
            fail(f"pipeline: compute_norm_factors wrote {written}")
        how = "the CLI (.npz and .joblib)"
    else:
        from m6anet_tpu_torch.data.norm import annotate_kmer_information, save_norm_factors

        train_info = labelled[labelled.set_type == "Train"].copy()
        start = time.perf_counter()
        factors = compute_norm_dict(os.path.join(demo, "data.json"),
                                    annotate_kmer_information(os.path.join(demo, "data.json"), train_info))
        os.makedirs(norm_dir)
        save_norm_factors(factors, npz)
        norm_wall = time.perf_counter() - start
        how = ("compute_norm_dict and save_norm_factors in this process: joblib does not import on this machine, "
               "so the CLI would write the .npz and then raise ImportError for the .joblib")
    log(f"[pipeline] norm factors by {how}: {norm_wall:.3f} s")
    want_labels = labels[labels.set_type == "Train"]
    want = compute_norm_dict(os.path.join(data, "data.json"), want_labels)
    got = load_norm_factors(npz)
    norm_rel = max(float(np.max(np.abs(got[k][i] - want[k][i]) / np.maximum(np.abs(want[k][i]), 1e-300)))
                   for k in want for i in (0, 1)) if sorted(got) == sorted(want) else float("inf")
    log(f"[pipeline] norm factors: {len(got)} 5-mers; means and stds against compute_norm_dict over "
        f"tests/data/data.json: {norm_rel:.3e} relative (tolerance {NORM_RTOL})")
    if norm_rel > NORM_RTOL:
        fail("pipeline: the norm factors differ from the reference data.json's")
    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=demo, norm_path=npz)
    cfg_path, save_dir = os.path.join(work_dir, "train.toml"), os.path.join(work_dir, "train_out")
    dump_toml(cfg, cfg_path)
    train_wall, proc = port_cli("pipeline train", "train", "--train_config", cfg_path, "--save_dir", save_dir,
                                "--epochs", "2", "--save_per_epoch", "2", "--num_iterations", "1")
    with open(os.path.join(save_dir, "train_results.json")) as f:
        losses = json.load(f)["avg_loss"]
    ckpt = os.path.join(save_dir, "model_states", "2", "model_states.npz")
    log(f"[pipeline] train on the card with those factors: {train_wall:.3f} s wall; train losses {losses}; "
        f"checkpoint written: {os.path.exists(ckpt)}")
    if not np.isfinite(losses).all() or not os.path.exists(ckpt) or "There are 57 train sites" not in proc.stdout:
        fail("pipeline: train with the port's norm factors gave non-finite losses, no checkpoint or other sites")
    report["norm"] = {"how": how, "wall_s": norm_wall, "kmers": len(got), "max_rel_vs_reference_json": norm_rel}
    report["train"] = {"wall_s": train_wall, "losses": losses}
    shutil.rmtree(demo)

    # ---- full size
    full = os.path.join(work_dir, "full")
    os.makedirs(full)
    eventalign = os.path.join(full, "eventalign.txt")
    start = time.perf_counter()
    size, n_contigs = write_copies(eventalign, PIPELINE_COPIES)
    log(f"[pipeline] {eventalign}: {size} bytes ({PIPELINE_COPIES} copies of the demo, {n_contigs} contigs "
        f"each), written in {time.perf_counter() - start:.3f} s")
    if size < 1 << 30:
        fail(f"pipeline: the synthetic eventalign holds {size} bytes, under 1 GiB")
    procs = min(cores, PIPELINE_MAX_PROCESSES)
    dataprep = {}
    for n in (procs, 1):
        out = os.path.join(full, f"np{n}")
        wall, _ = port_cli(f"pipeline dataprep --n_processes {n}", "dataprep", "--eventalign", eventalign,
                           "--out_dir", out, "--min_segment_count", "1", "--format", "both", "--n_processes", str(n))
        with open(os.path.join(out, "data.info")) as f:
            sites = sum(1 for _ in f) - 1
        dataprep[n] = {"wall_s": wall, "MB_per_s": size / wall / 1e6, "sites": sites, "sites_per_s": sites / wall}
        log(f"[pipeline] dataprep --format both --n_processes {n}: {wall:.3f} s wall, "
            f"{dataprep[n]['MB_per_s']:.1f} MB/s, {sites} sites, {dataprep[n]['sites_per_s']:.0f} sites/s "
            f"(host CPU {cpu_model}, {cores} cores; card {card})")
    differ = same_tree(os.path.join(full, f"np{procs}"), os.path.join(full, "np1"))
    log(f"[pipeline] --n_processes {procs} and 1: every output file the same bytes: {not differ}")
    if differ:
        fail(f"pipeline: --n_processes {procs} and 1 differ in {differ}")
    shutil.rmtree(os.path.join(full, "np1"))
    one = os.path.join(full, f"np{procs}")
    # the two host shards at once, as two hosts would run them, half the
    # processes each
    shards = [os.path.join(full, f"shard{h}") for h in range(2)]
    start = time.perf_counter()
    shard_procs = [subprocess.Popen(
        [sys.executable, "-m", "m6anet_tpu_torch", "dataprep", "--eventalign", eventalign, "--out_dir", out,
         "--min_segment_count", "1", "--format", "columnar", "--n_processes", str(max(1, procs // 2)),
         "--host_shard", str(h), "2"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h, out in enumerate(shards)]
    wait_ranks(shard_procs, "pipeline dataprep --host_shard", timeout=600)
    shard_wall = time.perf_counter() - start
    log(f"[pipeline] dataprep --host_shard 0 2 and 1 2 at once, {max(1, procs // 2)} processes each: "
        f"{shard_wall:.3f} s wall")
    os.remove(eventalign)
    out_one, out_concat = os.path.join(full, "calls_one"), os.path.join(full, "calls_concat")
    run = cli_in_process(logs, out_one, "--columnar", input_dir=one)
    with open(os.path.join(out_one, "data.site_proba.csv")) as f:
        scored = sum(1 for _ in f) - 1
    with open(os.path.join(out_one, "data.indiv_proba.csv")) as f:
        scored_reads = sum(1 for _ in f) - 1
    run.update(stages_s=stage_seconds(run["stages"]), sites=scored, reads=scored_reads,
               sites_per_s=scored / run["wall_s"])
    log(f"[pipeline] inference --columnar on the card over the one store (in this process): {run['wall_s']:.3f} s "
        f"wall; {run['path']}; stages {run['stages']}; {run['batches']} batches; kernel launches "
        f"{run['launches']}; {scored} sites, {scored_reads} reads scored, {run['sites_per_s']:.0f} sites/s "
        f"(card {card})")
    n_batches = run["batches"]
    if ("backend=cuda_fused" not in run["path"] or run["launches"]["read_prob_tc_f32x3"] != n_batches
            or run["launches"]["site_reduce"] != n_batches):
        fail(f"pipeline: the full-size inference ran as {run['path']!r} with launches {run['launches']}")
    check_finite(out_one, scored, scored_reads)
    concat = cli_in_process(logs, out_concat, "--columnar", "--concat_shards", input_dir=shards)
    identical = same_csvs(out_concat, out_one)
    log(f"[pipeline] inference --columnar --concat_shards over the two shards: {concat['wall_s']:.3f} s wall; "
        f"launches {concat['launches']}; CSVs the one-store run's bytes: {identical}")
    if not identical:
        fail("pipeline: --concat_shards over the shards does not give the one-store run's bytes")
    report["full"] = {
        "eventalign_bytes": size, "copies": PIPELINE_COPIES,
        "dataprep": {f"n_processes {n}": v for n, v in dataprep.items()}, "same_bytes_at_1_and_n": not differ,
        "host_shards_wall_s": shard_wall, "inference_columnar": run,
        "concat_shards": {"wall_s": concat["wall_s"], "launches": concat["launches"], "byte_identical": identical},
    }
    shutil.rmtree(work_dir, ignore_errors=True)
    report["wall_s"] = time.perf_counter() - phase_start
    log(f"[pipeline] phase 20: {report['wall_s']:.3f} s wall (host CPU {cpu_model}, {cores} cores; card {card})")
    return report


# ------------------------------------------------- widths and MC shapes
# phase 21: the production architecture at other widths, as (positions P,
# embedding E, hidden H1, hidden H2), each with seeded weights; W0 is the
# released models' own
WIDTHS = {"W0": (3, 2, 150, 32), "W1": (5, 2, 150, 32), "W2": (3, 3, 100, 20), "W3": (3, 4, 256, 64),
          "W4": (11, 4, 96, 24), "W5": (1, 1, 7, 3), "W6": (11, 4, 256, 64), "W7": (1, 4, 256, 64)}
WIDTHS_THRESHOLD = 0.5  # the seeded models' read threshold
OUTSIDE_ENVELOPE = (3, 2, 150, 65)  # H2 past the fast plans' 64: f32x3 and bf16 take their wide plans
VAST_VOCAB = (3, 2, 150, 32, 32768)  # a vocabulary past the int16 k-mer ids: refused
# phase 23: past the widths of the kernels' fast plans (positions P,
# embedding E, hidden H1, H2, vocabulary V where not 66)
PAST_WIDTHS = {"W8": (3, 2, 512, 32), "W9": (3, 2, 150, 128), "W10": (11, 8, 256, 64),
               "W11": (3, 2, 150, 32, 1024), "W12": (11, 8, 512, 128, 1024)}
# older fused_infer.cu and read_prob_tc.cu (the parent commit's, staged by
# git show before a run) to hold every width's bits and phase A times
# against, when present; their libraries build beside the script's own
PARENT_CSRC = os.path.join(ROOT, "build", "parent", "csrc")
# the torch backend's per-read tail of the signal-only model (n_in, H1, H2),
# held to the older fused_infer.cu built as the same tail (phase 13)
TAIL_WIDTHS = (9, 150, 32)
PARENT_BUILD = os.path.join(ROOT, "build", "parent", "lib")
# phase 22: draws per iteration, and the MC method of cuda_fused against the
# same function of the torch run's reads (PERF.md section 2)
MC_SAMPLES = (1, 20, 32, 128)
MC_TORCH_SITE_ATOL = 1e-5
LONG_SITE = 100_000  # the long site of phase 22's columnar store
# iterations of phase 22's ragged batch with long sites: one; one past the
# 256 f64 chains; the published 1,000; 1,500; one past 16 rows of chains
MC_LONG_ITERS = (1, 257, 1000, 1500, 4097)


def shape_variants():
    """(source, defines) of every library phases 21 to 23 build besides
    the defaults (past 128 k-mers, with int8 and with int16 ids)."""
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.ops import mc_kernel as mck

    widths = [fik.Widths(*w) for name, w in {**WIDTHS, **PAST_WIDTHS}.items() if name != "W0"]
    widths.append(fik.Widths(*OUTSIDE_ENVELOPE))
    out = [(source, fik.kernel_defines(w, id_bytes)) for w in widths for id_bytes in (1, 2)
           if id_bytes == 1 or w.vocab > 128 for source in ("fused_infer", "read_prob_tc")]
    return out + [("mc", mck.kernel_defines(n)) for n in MC_SAMPLES if n != mck.SAMPLES]


def mc_through_long_kernel(mck, p, offsets, counts, u, n_iters):
    """site_p with every site of 1 read or more through mc_long_site_kernel:
    mc.cu's staged launch sized for count 0 (NaN at those sites), then its
    long-site launch from count 0 over every such site.  Counts no launch."""
    from m6anet_tpu_torch.ops import _native

    lib = mck.kernel_lib()
    n_sites = counts.shape[0]
    site_p = torch.empty(n_sites, dtype=torch.float32, device=p.device)
    try:
        _native.launch(lib, "mc_site_launch", "ops.launch.mc_site", p.device, p.data_ptr(), offsets.data_ptr(),
                       counts.data_ptr(), u.data_ptr(), site_p.data_ptr(), n_sites, p.shape[0], n_iters,
                       mck.SAMPLES, 0)
        mck.launch_long_sites(lib, p, offsets, counts, u, site_p, mck.long_sites(counts, 0), n_iters, mck.SAMPLES, 0)
    except RuntimeError as exc:
        fail(f"MC: a launch from count 0 failed: {exc}")
    return site_p


def seeded_model(widths, seed=0):
    """The production architecture at ``widths`` with the port's init law
    (seeded), and BatchNorm's statistics and affine drawn as well, so that
    folding it into layer 1 is no identity."""
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    model = MILModel(fik.widths_config(fik.Widths(*widths))).init(torch.Generator().manual_seed(seed))
    bn = model.blocks[3].bn
    g = torch.Generator().manual_seed(seed + 1)
    n = bn.running_mean.shape[0]
    with torch.no_grad():
        bn.running_mean.copy_(0.2 * torch.randn(n, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(n, generator=g))
        bn.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
        bn.bias.copy_(0.2 * torch.randn(n, generator=g))
    return model.eval()


def widths_batch(widths, full_batch, seed):
    """The production batch's sites (offsets and counts) with seeded reads
    of a model of ``widths``: N(0, 1) features, k-mer ids uniform over 66."""
    rng = np.random.default_rng(seed)
    n, positions = full_batch[0].shape[0], widths[0]
    features = rng.standard_normal(size=(n, 3 * positions), dtype=np.float32)
    kmer = rng.integers(0, 66, size=(n, positions)).astype(np.int8)
    return features, kmer, full_batch[2], full_batch[3]


def write_long_runs(path, n_reads=30, n_pos=200):
    """An eventalign.txt of reads over long runs of consecutive positions
    (tests/test_dataprep.py's synthetic law; the demo's reads cover 3
    positions around each DRACH site, so dataprep --n_neighbors 2 finds no
    site in them): DRACH k-mers every 7 positions."""
    import random

    rng = random.Random(0)
    seq = "".join(rng.choice("ACGT") for _ in range(n_pos + 10))
    for i in range(5, n_pos, 7):
        seq = seq[:i] + "GGACT" + seq[i + 5 :]
    with open(os.path.join(ROOT, "tests", "data", "eventalign.txt")) as f:
        header = f.readline()
    with open(path, "w") as f:
        f.write(header)
        for read in range(n_reads):
            for pos in range(n_pos):
                kmer = seq[pos : pos + 5]
                mean = 90 + (pos * 7 + read) % 40 + 0.25
                f.write(f"SYNTX.1\t{pos}\t{kmer}\t{read}\tt\t{pos}\t{mean}\t2.5\t0.004\t"
                        f"{kmer}\t100.0\t3.0\t0.5\t{pos * 10}\t{pos * 10 + 8}\n")


class ParentBuild:
    """The older sources under PARENT_CSRC built, all at once in a thread
    started beside the script's own build: fused_infer.cu and
    read_prob_tc.cu (where both are staged) at W0 and at every tuple of
    WIDTHS and PAST_WIDTHS (int16 ids past 128 k-mers), keyed (widths name,
    source); mc.cu (where staged) at each of MC_SAMPLES, keyed (n_samples,
    "mc").  ``libs()`` waits for it and gives {key: CDLL} with the C
    interfaces declared, or None when no older sources are staged."""

    def __init__(self):
        from m6anet_tpu_torch.ops import _build
        from m6anet_tpu_torch.ops import encoder_kernel as enc
        from m6anet_tpu_torch.ops import fused_infer_kernel as fik
        from m6anet_tpu_torch.ops import mc_kernel as mck

        sources = {name: os.path.join(PARENT_CSRC, f"{name}.cu") for name in ("fused_infer", "read_prob_tc")}
        self.keys, self.paths, self.error, self.seconds = [], None, None, 0.0
        jobs = []

        def job(path, defines):
            return path, [_build.nvcc_path(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted(defines.items()))]

        if all(os.path.exists(p) for p in sources.values()):
            for name, widths in {**WIDTHS, **PAST_WIDTHS}.items():
                w = fik.Widths(*widths)
                for source, path in sources.items():
                    self.keys.append((name, source))
                    jobs.append(job(path, fik.kernel_defines(w, 2 if w.vocab > 128 else 1)))
            self.keys.append(("tail", "fused_infer"))
            jobs.append(job(sources["fused_infer"], enc.tail_defines(enc.TailWidths(*TAIL_WIDTHS))))
        mc_source = os.path.join(PARENT_CSRC, "mc.cu")
        if os.path.exists(mc_source):
            for n_samples in MC_SAMPLES:
                self.keys.append((n_samples, "mc"))
                jobs.append(job(mc_source, mck.kernel_defines(n_samples)))
        if not jobs:
            self.thread = None
            return

        def build():
            start = time.perf_counter()
            try:
                self.paths = _build.build_shared_libraries(jobs, out_dir=PARENT_BUILD)
            except Exception as exc:  # reported by libs()
                self.error = exc
            self.seconds = time.perf_counter() - start

        self.thread = threading.Thread(target=build)
        self.thread.start()

    def libs(self):
        from m6anet_tpu_torch.ops import _native
        from m6anet_tpu_torch.scripts import _sweep

        if self.thread is None:
            return None
        self.thread.join()
        if self.error is not None:
            fail(f"the older kernel sources under {PARENT_CSRC} did not build: {self.error}")
        out = {}
        for key, path in zip(self.keys, self.paths):
            if key[1] == "mc":  # a _native.Library, as mc_kernel.launch_long_sites takes it
                out[key] = _sweep.bind_mc(path, _sweep.mc_lists_sites(os.path.join(PARENT_CSRC, "mc.cu")))
            else:
                out[key] = _native.declare(path, key[1])
        return out


PARENT = None  # the ParentBuild main() starts


def parent_libs():
    """ParentBuild's libraries, starting the build here where main() did
    not (a phase run alone)."""
    global PARENT
    if PARENT is None:
        PARENT = ParentBuild()
    return PARENT.libs()


def check_parent(fp, full_batch):
    """W0 against the older sources under PARENT_CSRC: check_parent_phase_a
    (p the same bits, phase A times interleaved) and, through each
    precision's whole step, site_p and mod_ratio the same bits at the
    production batch.  None when no older sources are staged."""
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.scripts import _sweep

    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in full_batch)
    host = fik.checked_kmer_ids(full_batch[1])
    report = check_parent_phase_a("W0", fik.PRODUCTION, fp, features, kmer, host)
    if report is None:
        return None
    libs = parent_libs()
    old = libs[("W0", "fused_infer")]
    n, n_sites = features.shape[0], counts.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    for precision in P_ATOL:
        got = fik.fused_inference_t(fp, features, kmer, None, offsets, counts, THRESHOLD, 20, precision,
                                    host_kmer_ids=host)
        p, site_p, mr = got[0], torch.empty(n_sites, device="cuda"), torch.empty(n_sites, device="cuda")
        # the older phase B on this p: phase A's bits were held above
        if old.site_reduce_launch(p.data_ptr(), offsets.data_ptr(), counts.data_ptr(), site_p.data_ptr(),
                                  mr.data_ptr(), n, n_sites, THRESHOLD, 20, stream):
            fail(f"the older {precision} phase B did not launch")
        torch.cuda.synchronize()
        same = {"site_p": _sweep.same_bits(got[1], site_p), "mod_ratio": _sweep.same_bits(got[2], mr)}
        report[precision]["same_bits_sites"] = same
        log(f"[W0 parent] {precision}: site_p and mod_ratio the same bits as the older phase B's {same}")
        if not all(same.values()):
            fail(f"W0 {precision}: the kernels at the production widths do not give the older kernels' bits")
    return report


def check_parent_phase_a(name, w, fp, features, kmer, host):
    """Phase A of widths ``name`` (``w``) against the older sources' build
    at the same widths, in every precision on the same reads: p the same
    bits, and the device time of each beside the other, interleaved (CUDA
    events, L2 flushed; older, this, this, older).  None when no older
    sources are staged."""
    from m6anet_tpu_torch.ops import encoder_kernel as enc
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.scripts import _sweep

    libs = parent_libs()
    if libs is None or (name, "fused_infer") not in libs:
        log(f"[{name} parent] no older phase A sources under {PARENT_CSRC}: not compared")
        return None
    old, old_tc = libs[(name, "fused_infer")], libs[(name, "read_prob_tc")]
    n = features.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    report = {}
    for precision in P_ATOL:
        p_old = torch.empty(n, device="cuda")
        ptrs = (features.data_ptr(), kmer.data_ptr())
        if precision == "f32":
            def run_old():
                return old.read_prob_launch(*ptrs, fp.packed.data_ptr(), p_old.data_ptr(), n, stream)
        else:
            def run_old():
                return old_tc.read_prob_tc_launch(*ptrs, fp.tc.data_ptr(), p_old.data_ptr(), n,
                                                  fik.TC_MODES[precision], stream)
        if run_old():
            fail(f"{name}: the older {precision} phase A did not launch")
        p_new = enc.fused_read_probability(fp, features, kmer, precision, host_kmer_ids=host)
        torch.cuda.synchronize()
        same = _sweep.same_bits(p_new, p_old)
        times, clocks = _sweep.time_interleaved(
            [run_old, lambda: enc.fused_read_probability(fp, features, kmer, precision, host_kmer_ids=host)], reps=10)
        old_ms, new_ms = (statistics.median(t) for t in times)
        report[precision] = {"same_bits": same, "older_ms": old_ms, "ms": new_ms, "ratio": new_ms / old_ms,
                             "wide": fik.phase_a_wide(precision, w, kmer.element_size()), "sm_clocks": clocks}
        log(f"[{name} parent] {precision}: p the same bits as the older kernel's: {same}; phase A {new_ms:.4f} ms "
            f"against the older {old_ms:.4f} ms ({new_ms / old_ms:.4f}x; SM clock {clocks})")
        if not same:
            fail(f"{name} {precision}: phase A does not give the older kernel's bits")
    return report


def check_parent_tail(tp, x):
    """The torch backend's per-read tail of TAIL_WIDTHS (``tp``, on the
    inputs ``x`` its head blocks give) against the older fused_infer.cu
    built as the same tail: p the same bits, and the device time of each
    beside the other, interleaved (CUDA events, L2 flushed; older, this,
    this, older).  None when no older sources are staged."""
    from m6anet_tpu_torch.ops import encoder_kernel as enc
    from m6anet_tpu_torch.scripts import _sweep

    libs = parent_libs()
    if libs is None or ("tail", "fused_infer") not in libs:
        log(f"[tail parent] no older phase A sources under {PARENT_CSRC}: not compared")
        return None
    if tuple(tp.widths[:3]) != TAIL_WIDTHS:
        fail(f"the tail's widths {tp.widths} are not TAIL_WIDTHS {TAIL_WIDTHS}")
    old = libs[("tail", "fused_infer")]
    n = x.shape[0]
    p_old = torch.empty(n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run_old():
        return old.read_prob_launch(x.data_ptr(), None, tp.packed.data_ptr(), p_old.data_ptr(), n, stream)

    if run_old():
        fail("the older tail did not launch")
    p_new = enc.read_prob_tail(tp, x)
    torch.cuda.synchronize()
    same = _sweep.same_bits(p_new, p_old)
    times, clocks = _sweep.time_interleaved([run_old, lambda: enc.read_prob_tail(tp, x)], reps=10)
    old_ms, new_ms = (statistics.median(t) for t in times)
    log(f"[tail parent] {TAIL_WIDTHS}: p the same bits as the older kernel's: {same}; the tail {new_ms:.4f} ms "
        f"against the older {old_ms:.4f} ms ({new_ms / old_ms:.4f}x; SM clock {clocks})")
    if not same:
        fail("the tail's phase A does not give the older kernel's bits")
    return {"same_bits": same, "older_ms": old_ms, "ms": new_ms, "ratio": new_ms / old_ms, "sm_clocks": clocks}


def cublas_chain_ms(fp, features, kmer):
    """The plain encoder as cuBLAS matmuls on inputs gathered beforehand,
    x @ W1^T + b1 -> relu -> @ W2^T + b2 -> relu -> . w3 + b3 -> sigmoid,
    timed in f32 (TF32 off) and in bf16 (inputs and weights cast first):
    the library yardstick of the wide kernels (ms, CUDA events, L2
    flushed)."""
    x = torch.cat([features, fp.embt.t()[kmer.long()].reshape(features.shape[0], -1)], dim=1)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xx, w1, w2 = x.to(dtype), fp.w1t.to(dtype), fp.w2t.to(dtype)
        b1, b2, w3, b3 = (t.reshape(-1).to(dtype) for t in (fp.b1t, fp.b2t, fp.w3t, fp.b3t))
        out[name] = time_ms(lambda: torch.sigmoid(
            torch.relu(torch.addmm(b2, torch.relu(torch.addmm(b1, xx, w1.t())), w2.t())) @ w3 + b3), reps=10)
    return out


def check_tail_residues(fik, enc, fp, w, precision, seed):
    """Phase A of ``precision`` on batches of 2 T + r reads for every r in
    [0, T) (T its block's tile: the last tile cut at every residue) against
    the plain version on the batch of 3 T, and bit for bit against the same
    reads' p there (a read's p does not depend on the batch).  Returns the
    largest |p - plain|."""
    from m6anet_tpu_torch.scripts import _sweep

    tile = fik.read_tile_reads(precision, w)
    rng = np.random.default_rng(seed)
    n = 3 * tile
    X = rng.standard_normal(size=(n, w.features), dtype=np.float32)
    K = rng.integers(0, w.vocab, size=(n, w.positions)).astype(fik.kmer_dtype(w.vocab))
    features, kmer = torch.from_numpy(X).cuda(), torch.from_numpy(K).cuda()
    whole = enc.fused_read_probability(fp, features, kmer, precision, host_kmer_ids=fik.checked_kmer_ids(K, w.vocab))
    err, _, ok = p_check(whole, fik.read_probability_plain(fp, features, kmer, precision), precision)
    cut = [r for r in range(tile) if not _sweep.same_bits(
        enc.fused_read_probability(fp, features[: 2 * tile + r], kmer[: 2 * tile + r], precision,
                                   host_kmer_ids=fik.checked_kmer_ids(K[: 2 * tile + r], w.vocab)),
        whole[: 2 * tile + r])]
    log(f"[tail residues] {w} {precision}: tile {tile}, batches of {2 * tile}..{3 * tile - 1} reads; max|dp| "
        f"{err:.3e} against plain; residues whose p differs from the whole batch's: {cut}")
    if not ok or cut:
        fail(f"{w} {precision}: phase A's tail residues disagree")
    return err


def run_trained_widths(logs, work_dir, widths):
    """The train CLI (2 epochs on tests/data) on a model of ``widths``
    written as an m6anet.toml, then the inference CLI over tests/data with
    --model_config and --model_state_dict on the card: --backend auto (it
    must take cuda_fused at f32x3 and launch each of the path's kernels
    once a batch) against --backend torch at phase 16's rule, and against
    its own plain version."""
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH, TRAIN_CONFIG_TEMPLATE
    from m6anet_tpu_torch.data.dataset import build_dataset
    from m6anet_tpu_torch.models import load_model
    from m6anet_tpu_torch.ops import encoder_kernel as enc
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.utils.config import dump_toml, load_toml

    os.makedirs(work_dir, exist_ok=True)
    model_toml = os.path.join(work_dir, "m6anet_w.toml")
    dump_toml(fik.widths_config(fik.Widths(*widths)), model_toml)
    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=os.path.join(ROOT, "tests", "data"), norm_path=DEFAULT_NORM_PATH)
    cfg_path, save_dir = os.path.join(work_dir, "train.toml"), os.path.join(work_dir, "train_out")
    dump_toml(cfg, cfg_path)
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "m6anet_tpu_torch", "train", "--model_config", model_toml,
                           "--train_config", cfg_path, "--save_dir", save_dir, "--epochs", "2",
                           "--save_per_epoch", "2", "--num_iterations", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    train_wall = time.perf_counter() - start
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
        fail(f"train CLI at widths {widths} exited {proc.returncode}")
    with open(os.path.join(save_dir, "train_results.json")) as f:
        losses = json.load(f)["avg_loss"]
    if not np.isfinite(losses).all():
        fail(f"train CLI at widths {widths}: non-finite losses {losses}")
    state = os.path.join(save_dir, "avg_loss.npz")
    flags = ["--model_config", model_toml, "--model_state_dict", state,
             "--read_proba_threshold", str(WIDTHS_THRESHOLD)]
    out_auto, out_torch = os.path.join(work_dir, "auto"), os.path.join(work_dir, "torch")
    wall, path, batches, launches = run_cli("HCT116_RNA002", out_auto, flags)
    if "backend=cuda_fused" not in path or "precision=f32x3" not in path or "device=cuda" not in path:
        fail(f"--backend auto at widths {widths} ran as {path!r}, not cuda_fused f32x3 on the card")
    wide = batches if fik.phase_a_wide("f32x3", fik.Widths(*widths)) else 0
    if (any(launches[k] != batches for k in ("fused_inference_t", "read_prob_tc_f32x3", "site_reduce"))
            or launches["read_prob_wide_f32x3"] != wide):
        fail(f"--backend auto at widths {widths}: launches {launches} in {batches} batches")
    torch_wall, torch_path, torch_batches, launches_torch = run_cli("HCT116_RNA002", out_torch,
                                                                   [*flags, "--backend", "torch"])
    # the torch step on the card runs the model's tail in the kernel where its plan is fast
    tail_lib = enc.tail_lib(enc.TailWidths(fik.Widths(*widths).n_in, widths[2], widths[3]))
    if "backend=torch" not in torch_path or not torch_launches(
            launches_torch, torch_batches, not tail_lib.plan["f32"]["wide"], tail_lib.lane_group > 1):
        fail(f"--backend torch at widths {widths} ran as {torch_path!r} with launches {launches_torch}")
    model = load_model(fik.widths_config(fik.Widths(*widths)), state)
    dataset = build_dataset(os.path.join(ROOT, "tests", "data"), min_reads=20, norm_path=DEFAULT_NORM_PATH,
                            mode="Inference")
    errors, fp, batch, site_batch = mode_errors(model, dataset, WIDTHS_THRESHOLD)
    read_atol = max(ENGINE_READ_ATOL["f32x3"], 2 * errors["f32x3"])
    gaps = hold_outputs(out_auto, out_torch, WIDTHS_THRESHOLD, read_atol, None, f"W{widths} auto vs torch")
    plain_dir = write_plain_outputs(fp, batch, site_batch, "f32x3", WIDTHS_THRESHOLD, out_auto + "_plain")
    plain_gaps = hold_outputs(out_auto, plain_dir, WIDTHS_THRESHOLD, P_ATOL["f32x3"], SITE_ATOL,
                              f"W{widths} auto vs plain f32x3")
    log(f"[widths e2e] {widths}: train {train_wall:.1f} s (losses {losses}); inference auto {wall:.2f} s ({path}; "
        f"{batches} batches; launches {launches}), torch {torch_wall:.2f} s; f32x3 error against f64 {errors}")
    return {"train_wall_s": train_wall, "train_losses": losses, "auto_wall_s": wall, "path": path,
            "batches": batches, "launches": launches, "vs_torch": gaps, "vs_plain": plain_gaps,
            "mode_error_vs_f64": errors}


class SyntheticSites:
    """A feed of ``n_sites`` sites of 20 to 60 seeded reads at ``positions``
    k-mer positions, as run_inference takes a dataset: N(0, 1) features,
    k-mer ids uniform over the 66, a GGACT centre."""

    def __init__(self, positions, n_sites=120, seed=0):
        from m6anet_tpu_torch.data.dataset import Site

        rng = np.random.default_rng(seed)
        pad = "A" * ((positions - 1) // 2)
        self.sites = []
        for i in range(n_sites):
            n = int(rng.integers(20, 61))
            self.sites.append(Site(
                tx_id=f"SYN{i // 40}", tx_pos=10 * i, read_ids=np.arange(n, dtype=np.int64),
                features=rng.standard_normal(size=(n, 3 * positions), dtype=np.float32),
                kmer_ids=rng.integers(0, 66, size=positions).astype(np.int32),
                sequence=pad + "GGACT" + pad))
        self.max_site_reads = max(len(site.read_ids) for site in self.sites)

    def __len__(self):
        return len(self.sites)

    def iter_sites(self, n_threads=1):
        return iter(self.sites)


def run_neighbors(logs, work_dir, widths):
    """Five k-mer positions (dataprep --n_neighbors 2): the port's dataprep
    over tests/data/eventalign.txt (no site: the demo's reads cover 3
    positions around each DRACH site) and over write_long_runs' reads (their
    sites' outer 5-mers lie outside the 66 of the k-mer vocabulary, which
    the dataset, as the JAX package's, refuses); then run_inference in this
    process over SyntheticSites at 5 positions with a seeded model of
    ``widths`` on cuda_fused (backend auto) against --backend torch on the
    card, at phase 16's rule."""
    import pandas as pd

    from m6anet_tpu_torch.cli import main as cli_main
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH
    from m6anet_tpu_torch.data.dataset import build_dataset

    os.makedirs(work_dir, exist_ok=True)
    demo_dp, synth_dp = os.path.join(work_dir, "demo_dp"), os.path.join(work_dir, "synth_dp")
    synth = os.path.join(work_dir, "long_runs.txt")
    write_long_runs(synth)
    for source, out in ((os.path.join(ROOT, "tests", "data", "eventalign.txt"), demo_dp), (synth, synth_dp)):
        cli_main(["dataprep", "--eventalign", source, "--out_dir", out, "--n_neighbors", "2",
                  "--min_segment_count", "1", "--format", "both", "--n_processes", "2"])
    demo_sites_n = len(pd.read_csv(os.path.join(demo_dp, "data.info")))
    synth_sites_n = len(pd.read_csv(os.path.join(synth_dp, "data.info")))
    try:
        next(build_dataset(synth_dp, min_reads=20, norm_path=DEFAULT_NORM_PATH, num_neighboring_features=2,
                           mode="Inference").iter_sites())
        vocabulary = "the first site's k-mers lie in the vocabulary"
    except KeyError as err:
        vocabulary = f"the dataset refuses the k-mer {err} outside the 66 of the vocabulary"
    dataset = SyntheticSites(widths[0])
    model = seeded_model(widths, seed=1)
    runs = {name: engine_run(logs, copy.deepcopy(model), dataset, os.path.join(work_dir, name), WIDTHS_THRESHOLD,
                             backend=backend)
            for name, backend in (("auto", "auto"), ("torch", "torch"))}
    if "backend=cuda_fused" not in runs["auto"]["path"] or runs["auto"]["launches"]["read_prob_tc_f32x3"] < 1:
        fail(f"5 positions: auto ran as {runs['auto']['path']!r} with launches {runs['auto']['launches']}")
    errors, *_ = mode_errors(model, dataset, WIDTHS_THRESHOLD)
    read_atol = max(ENGINE_READ_ATOL["f32x3"], 2 * errors["f32x3"])
    rows = (sum(len(site.read_ids) for site in dataset.sites), len(dataset))
    gaps = hold_outputs(os.path.join(work_dir, "auto"), os.path.join(work_dir, "torch"), WIDTHS_THRESHOLD, read_atol,
                        None, "5 positions auto vs torch", rows=rows)
    log(f"[widths 5 positions] dataprep --n_neighbors 2 on the demo: {demo_sites_n} sites; on long runs: "
        f"{synth_sites_n} sites, and {vocabulary}; {rows[1]} synthetic sites of {rows[0]} reads: auto "
        f"{runs['auto']['path']}, launches {runs['auto']['launches']}; f32x3 error against f64 {errors}")
    return {"demo_sites": demo_sites_n, "long_run_sites": synth_sites_n, "vocabulary": vocabulary,
            "sites": rows[1], "reads": rows[0], "vs_torch": gaps,
            "auto": {k: v for k, v in runs["auto"].items()}}


def check_widths(logs, work_dir, full_batch, peak_flops):
    """Phase 21: every tuple of WIDTHS on the kernels against their plain
    versions, W0 against the older sources, a model trained at W3 and a
    5-position dataset end to end, and a model outside the envelope
    refused before any launch."""
    from m6anet_tpu_torch.ops import _build
    from m6anet_tpu_torch.ops import encoder_kernel as enc
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.ops import site_ops

    report = {}
    rng = np.random.default_rng(21)
    for k, (name, widths) in enumerate(WIDTHS.items()):
        w = fik.Widths(*widths)
        fp = fik.prepare_fused_params_t(seeded_model(widths).cuda())
        defines = fik.kernel_defines(w)
        f32_lib, tc_lib = (_build.cuda_library(src, defines) for src in ("fused_infer", "read_prob_tc"))
        ptxas = {"read_prob_kernel": _build.ptxas_usage(f32_lib, "read_prob_kernel"),
                 **{f"read_prob_tc_kernel {mode}": _build.ptxas_usage(tc_lib, f"read_prob_tc_kernelILi{fik.TC_MODES[mode]}E")
                    for mode in MODES}}
        configs = fik.kernel_lib(w, precision="f32x3").plan
        for mode in MODES:
            if configs[mode]["dynamic_smem_bytes"] > fik.SHARED_LIMIT_BYTES:
                fail(f"{name} {mode}: the kernel's shared memory {configs[mode]} passes a block's "
                     f"{fik.SHARED_LIMIT_BYTES} bytes")
        small = make_batch(rng, 4096, 128, small_count(rng), widths)
        big = widths_batch(widths, full_batch, seed=100 + k)
        errors = {}
        for precision in ("f32", *MODES):
            tile = fik.read_tile_reads(precision, w)
            err = compare(fik, fp, small, f"{name} small", precision, WIDTHS_THRESHOLD)
            for batch in fik.ragged_tail_batches(tile, seed=4 + k, widths=w):
                err = max(err, compare(fik, fp, batch, f"{name} tail {batch[0].shape[0]}", precision,
                                       WIDTHS_THRESHOLD))
            errors[precision] = max(err, compare(fik, fp, big, f"{name} full", precision, WIDTHS_THRESHOLD))
        if name == "W3":
            for precision in ("f32", *MODES):
                for batch in (small, big):
                    compare_entries(fik, enc, site_ops, fp, batch, f"{name} entries {batch[0].shape[0]}", precision)
        features, kmer = (torch.from_numpy(a).cuda() for a in big[:2])
        host = fik.checked_kmer_ids(big[1])
        phase_a_ms = {precision: time_ms(lambda: enc.fused_read_probability(fp, features, kmer, precision,
                                                                              host_kmer_ids=host))
                      for precision in ("f32", *MODES)}
        flop = 2 * (w.n_in * w.hidden1 + w.hidden1 * w.hidden2 + w.hidden2) * features.shape[0]
        bound_ms = flop / peak_flops * 1e3
        f32_tile = fik.read_tile_reads("f32", w)
        report[name] = {"widths": widths, "f32_tile_reads": f32_tile, "ptxas": ptxas,
                        "tc_launch": configs, "max_abs_err": errors, "phase_a_ms": phase_a_ms,
                        "f32_bound_ms": bound_ms, "reads": features.shape[0]}
        log(f"[widths] {name} {widths}: f32 tile {f32_tile} reads, tensor-core blocks {configs}; ptxas {ptxas}; "
            f"kernel vs plain {errors}; "
            f"phase A at {features.shape[0]} reads {phase_a_ms} ms, f32 bound {bound_ms:.4f} ms")
        if name == "W0":
            report["W0 parent"] = check_parent(fp, full_batch)
        else:
            report[name]["parent"] = check_parent_phase_a(name, w, fp, features, kmer, host)
    report["W3 trained"] = run_trained_widths(logs, os.path.join(work_dir, "trained"), WIDTHS["W3"])
    report["W1 5 positions"] = run_neighbors(logs, os.path.join(work_dir, "neighbors"), WIDTHS["W1"])
    report["outside"] = check_outside_envelope(logs, os.path.join(work_dir, "outside"))
    return report


def check_outside_envelope(logs, out_dir):
    """A model of OUTSIDE_ENVELOPE's widths (H2 past the fast plans)
    through run_inference on the card with backend auto: cuda_fused at
    f32x3, on the wide plan, each kernel once a batch, against --backend
    torch at phase 16's rule; and a model of VAST_VOCAB (a vocabulary past
    the int16 k-mer ids): a ValueError before any launch or CSV."""
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH
    from m6anet_tpu_torch.data.dataset import build_dataset
    from m6anet_tpu_torch.inference.engine import run_inference

    dataset = build_dataset(os.path.join(ROOT, "tests", "data"), min_reads=20, norm_path=DEFAULT_NORM_PATH,
                            mode="Inference")
    model = seeded_model(OUTSIDE_ENVELOPE)
    runs = {name: engine_run(logs, copy.deepcopy(model), dataset, os.path.join(out_dir, name), WIDTHS_THRESHOLD,
                             backend=backend) for name, backend in (("auto", "auto"), ("torch", "torch"))}
    auto = runs["auto"]
    if ("backend=cuda_fused" not in auto["path"] or "precision=f32x3" not in auto["path"]
            or any(auto["launches"][k] != auto["batches"]
                   for k in ("fused_inference_t", "read_prob_tc_f32x3", "read_prob_wide_f32x3", "site_reduce"))):
        fail(f"{OUTSIDE_ENVELOPE} under auto ran as {auto['path']!r} with launches {auto['launches']}")
    errors, *_ = mode_errors(model, dataset, WIDTHS_THRESHOLD)
    gaps = hold_outputs(os.path.join(out_dir, "auto"), os.path.join(out_dir, "torch"), WIDTHS_THRESHOLD,
                        max(ENGINE_READ_ATOL["f32x3"], 2 * errors["f32x3"]), None, f"{OUTSIDE_ENVELOPE} auto vs torch")
    log(f"[widths] {OUTSIDE_ENVELOPE} on {auto['path']}: launches {auto['launches']} in {auto['batches']} batches")
    refused_dir = os.path.join(out_dir, "vast")
    reset_launch_counts()
    try:
        run_inference(seeded_model(VAST_VOCAB), dataset, refused_dir, WIDTHS_THRESHOLD)
    except ValueError as err:
        refused = str(err)
    else:
        fail(f"a model of widths {VAST_VOCAB} ran on the card under auto")
    if any(read_launch_counts().values()) or os.path.exists(os.path.join(refused_dir, "data.site_proba.csv")):
        fail(f"a model past the int16 k-mer ids launched a kernel or wrote a CSV: {read_launch_counts()}")
    log(f"[widths] {VAST_VOCAB} refused before any batch: {refused}")
    return {"widths": OUTSIDE_ENVELOPE, "path": auto["path"], "launches": auto["launches"],
            "batches": auto["batches"], "vs_torch": gaps, "mode_error_vs_f64": errors,
            "refused": {"widths": VAST_VOCAB, "error": refused}}


def phase_a_bound_ms(w, precision, n_reads, id_bytes, peak_flops, peak_bw):
    """The least time phase A of ``precision`` could take at widths ``w``
    over ``n_reads`` reads, and what bounds it: the larger of its bytes
    (features, k-mer ids of ``id_bytes``, p) over ``peak_bw`` and its
    operations over their pipe's peak (f32 on the FP32 cores; f32x3 layer
    1 there and its three bf16 passes over layer 2 and the head on the
    tensor cores, another pipe; bf16 all on the tensor cores)."""
    f32 = 2 * (w.n_in * w.hidden1 + w.hidden1 * w.hidden2 + w.hidden2)
    flop = {"f32": (f32, 0), "f32x3": (2 * w.n_in * w.hidden1, 3 * 2 * (w.hidden1 * w.hidden2 + w.hidden2)),
            "bf16": (0, f32)}[precision]
    op_ms = max(flop[0] / peak_flops, flop[1] / BF16_TENSOR_FLOPS) * n_reads * 1e3
    byte_ms = (12 * w.positions + id_bytes * w.positions + 4) * n_reads / peak_bw * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def run_wide_engine(logs, work_dir, widths):
    """A seeded model of ``widths`` (past every fast plan) through
    run_inference over SyntheticSites on the card in each precision of
    cuda_fused: each kernel of the path once a batch, the wide phase A
    among them; each run against --backend torch at phase 16's rule and
    against its own plain version.  Returns the runs' reports."""
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik

    w = fik.Widths(*widths)
    dataset = SyntheticSites(w.positions)
    model = seeded_model(widths, seed=2)
    rows = (sum(len(site.read_ids) for site in dataset.sites), len(dataset))
    out = {name: os.path.join(work_dir, name) for name in ("torch", *P_ATOL)}
    runs = {"torch": engine_run(logs, copy.deepcopy(model), dataset, out["torch"], WIDTHS_THRESHOLD, backend="torch")}
    errors, fp, batch, site_batch = mode_errors(model, dataset, WIDTHS_THRESHOLD)
    report = {"widths": widths, "mode_error_vs_f64": errors}
    for precision in P_ATOL:
        runs[precision] = rep = engine_run(logs, copy.deepcopy(model), dataset, out[precision], WIDTHS_THRESHOLD,
                                           backend="cuda_fused", precision=precision)
        wide = rep["batches"] if fik.phase_a_wide(precision, w) else 0
        path = ["fused_inference_t", "site_reduce"] + ([f"read_prob_tc_{precision}"] if precision in MODES else [])
        if (f"backend=cuda_fused precision={precision}" not in rep["path"]
                or any(rep["launches"][k] != rep["batches"] for k in path)
                or rep["launches"][f"read_prob_wide_{precision}"] != wide):
            fail(f"[{widths} {precision}] ran as {rep['path']!r} with launches {rep['launches']}")
        read_atol = max(ENGINE_READ_ATOL[precision], 2 * errors[precision])
        vs_torch = hold_outputs(out[precision], out["torch"], WIDTHS_THRESHOLD, read_atol,
                                SITE_ATOL if precision == "f32" else None, f"{widths} {precision} vs torch", rows=rows)
        plain_dir = write_plain_outputs(fp, batch, site_batch, precision, WIDTHS_THRESHOLD, out[precision] + "_plain")
        vs_plain = hold_outputs(out[precision], plain_dir, WIDTHS_THRESHOLD, P_ATOL[precision], SITE_ATOL,
                                f"{widths} {precision} vs plain", rows=rows)
        report[precision] = {"wall_s": rep["wall_s"], "path": rep["path"], "batches": rep["batches"],
                             "launches": rep["launches"], "vs_torch": vs_torch, "vs_plain": vs_plain}
        log(f"[past e2e] {widths} {precision}: {rep['wall_s']:.2f} s; {rep['path']}; {rep['batches']} batches; "
            f"launches {rep['launches']}")
    return report


def check_past_envelope(logs, work_dir, full_batch, peak_flops, peak_bw):
    """Phase 23: every tuple of PAST_WIDTHS on the kernels against their
    plain versions in all three precisions (a small ragged batch with the
    dataset's int8 ids, the ragged tails of each phase A's tile and a
    1,048,576-read batch with ids over the whole vocabulary, int16 past 128
    k-mers; repeats bit-identical), each library's ptxas report, each
    phase A timed beside its f32 bound; both entry points at W12 with int32
    ids up to V - 1; a W12 model through run_inference in each precision;
    a model trained at W9 through the CLI with --backend auto."""
    from m6anet_tpu_torch.ops import _build
    from m6anet_tpu_torch.ops import encoder_kernel as enc
    from m6anet_tpu_torch.ops import fused_infer_kernel as fik
    from m6anet_tpu_torch.ops import site_ops

    report = {}
    rng = np.random.default_rng(23)
    for k, (name, widths) in enumerate(PAST_WIDTHS.items()):
        w = fik.Widths(*widths)
        fp = fik.prepare_fused_params_t(seeded_model(widths).cuda())
        id_bytes = 2 if w.vocab > 128 else 1
        libs = {src: _build.cuda_library(src, fik.kernel_defines(w, id_bytes)) for src in ("fused_infer", "read_prob_tc")}
        kernels = {precision: fik.phase_a_kernel(precision, w, id_bytes) for precision in P_ATOL}
        ptxas = {precision: {"kernel": kernel, **_build.ptxas_usage(libs["fused_infer" if precision == "f32" else
                                                                          "read_prob_tc"], kernel)}
                 for precision, kernel in kernels.items()}
        configs = fik.kernel_lib(w, id_bytes, "f32x3").plan
        small = make_batch(rng, 4096, 128, small_count(rng), widths)
        brng = np.random.default_rng(200 + k)
        n = full_batch[0].shape[0]
        big = (brng.standard_normal(size=(n, w.features), dtype=np.float32),
               brng.integers(0, w.vocab, size=(n, w.positions)).astype(fik.kmer_dtype(w.vocab)),
               full_batch[2], full_batch[3])
        errors = {}
        for precision in P_ATOL:
            err = compare(fik, fp, small, f"{name} small", precision, WIDTHS_THRESHOLD)
            for batch in fik.ragged_tail_batches(fik.read_tile_reads(precision, w), seed=40 + k, widths=w):
                err = max(err, compare(fik, fp, batch, f"{name} tail {batch[0].shape[0]}", precision,
                                       WIDTHS_THRESHOLD))
            errors[precision] = max(err, compare(fik, fp, big, f"{name} full", precision, WIDTHS_THRESHOLD))
        features, kmer = (torch.from_numpy(a).cuda() for a in big[:2])
        host = fik.checked_kmer_ids(big[1], w.vocab)
        phase_a_ms = {precision: time_ms(lambda: enc.fused_read_probability(fp, features, kmer, precision,
                                                                              host_kmer_ids=host), reps=10)
                      for precision in P_ATOL}
        bounds = {precision: phase_a_bound_ms(w, precision, n, id_bytes, peak_flops, peak_bw) for precision in P_ATOL}
        f32_bound_ms = bounds["f32"][0]
        for precision in P_ATOL:
            if fik.phase_a_wide(precision, w, id_bytes):
                errors[precision] = max(errors[precision], check_tail_residues(fik, enc, fp, w, precision, 60 + k))
        report[name] = {"widths": widths, "ptxas": ptxas, "tc_launch": configs, "max_abs_err": errors,
                        "phase_a_ms": phase_a_ms, "f32_bound_ms": f32_bound_ms,
                        "bound_ms": {p: b[0] for p, b in bounds.items()},
                        "bound_by": {p: b[1] for p, b in bounds.items()}, "reads": n, "id_bytes": id_bytes,
                        "cublas_ms": cublas_chain_ms(fp, features, kmer),
                        "parent": check_parent_phase_a(name, w, fp, features, kmer, host)}
        if name == "W12":
            ids32 = (small[0], rng.integers(0, w.vocab, size=small[1].shape).astype(np.int32), small[2], small[3])
            ids32[1][0] = w.vocab - 1
            report[name]["entries_int32"] = {precision: compare_entries(fik, enc, site_ops, fp, ids32,
                                                                        f"{name} entries int32", precision)
                                             for precision in P_ATOL}
            report[name]["plain_ms"] = {precision: time_ms(lambda: enc.fused_read_probability_plain(
                fp, features, kmer, precision), reps=1) for precision in P_ATOL}
        log(f"[past] {name} {widths}: kernels {kernels}; ptxas {ptxas}; tensor-core launches {configs}; kernel vs "
            f"plain {errors}; phase A at {n} reads {phase_a_ms} ms, bounds {bounds}; the cuBLAS chain "
            f"{report[name]['cublas_ms']} ms")
    report["W12 engine"] = run_wide_engine(logs, os.path.join(work_dir, "w12"), PAST_WIDTHS["W12"])
    report["W9 trained"] = run_trained_widths(logs, os.path.join(work_dir, "trained"), PAST_WIDTHS["W9"])
    return report


def check_mc_shapes(logs, work_dir, peak_flops, peak_bw):
    """Phase 22: the MC kernels on sites above the staged cap and at other
    draws per iteration, against the plain version and, where staged, the
    older mc.cu (every site_p the same bits); the short sites' bits with
    and without long ones beside them, and through the long-site kernel;
    run_inference of a columnar store holding a 100,000-read site against
    --backend torch; check_long_sites' shapes, bits and times."""
    from m6anet_tpu_torch.constants import DEFAULT_NORM_PATH, PRETRAINED_CONFIGS
    from m6anet_tpu_torch.data.columnar import ColumnarSiteDataset, ColumnarWriter
    from m6anet_tpu_torch.data.norm import load_norm_factors, site_norm_vectors
    from m6anet_tpu_torch.models import load_model
    from m6anet_tpu_torch.ops import _build
    from m6anet_tpu_torch.ops import mc_kernel as mck
    from m6anet_tpu_torch.ops import random as prng
    from m6anet_tpu_torch.scripts import _sweep
    from m6anet_tpu_torch.scripts._sweep import same_bits

    report = {}
    p, offsets, counts = (torch.from_numpy(a).cuda() for a in mck.ragged_mc_batch(long_sites=True))
    p0, off0, cnt0 = (torch.from_numpy(a).cuda() for a in mck.ragged_mc_batch())
    short = torch.cat([torch.arange(len(cnt0) - 16), torch.arange(len(counts) - 16, len(counts))]).cuda()
    host = (offsets.cpu().numpy(), counts.cpu().numpy())
    libs = parent_libs()
    older = {n: libs.get((n, "mc")) for n in MC_SAMPLES} if libs else {}
    if not any(older.values()):
        log(f"[MC parent] no older mc.cu under {PARENT_CSRC}: long sites not compared with it")
    older_lists = any(older.values()) and _sweep.mc_lists_sites(os.path.join(PARENT_CSRC, "mc.cu"))
    report["parent_same_bits"] = {}

    def same_as_parent(label, got, p, offsets, counts, u, n_iters):
        """got against the older mc.cu's site_p on the same inputs, where staged."""
        plib = older.get(u.shape[0])
        if plib is None:
            return
        same = same_bits(got, _sweep.mc_site_p(plib, older_lists, p, offsets, counts, u, n_iters))
        report["parent_same_bits"][label] = same
        log(f"[MC parent] {label}: every site_p the older mc.cu's bits: {same}")
        if not same:
            fail(f"MC {label}: the long-site kernel does not give the older kernel's bits")

    errs = []
    for n_iters in MC_LONG_ITERS:
        u = torch.from_numpy(prng.shared_draws(0, n_iters)).cuda()
        errs.append(compare_mc(mck, p, offsets, counts, host, u, n_iters, f"MC long sites T={n_iters}"))
        alone = mck.site_probability_mc_cuda(p0, off0, cnt0, u, n_iters)
        with_long = mck.site_probability_mc_cuda(p, offsets, counts, u, n_iters, host_sites=host)
        through_long = mc_through_long_kernel(mck, p, offsets, counts, u, n_iters)
        torch.cuda.synchronize()
        kept = same_bits(with_long[short], alone)
        same_path = same_bits(through_long, with_long)
        log(f"[MC long sites] T={n_iters}: the sites of <= {mck.MAX_STAGED_READS} reads the same bits beside the "
            f"long sites as without them: {kept}; every site through the long-site kernel the same bits: {same_path}")
        if not (kept and same_path):
            fail("MC: a site's value depends on the long sites beside it, or on the kernel that takes it")
        same_as_parent(f"ragged T={n_iters}", with_long, p, offsets, counts, u, n_iters)
    for n_samples in MC_SAMPLES:
        u = torch.from_numpy(prng.shared_draws(0, 1000, n_samples)).cuda()
        got = mck.site_probability_mc_cuda(p, offsets, counts, u, 1000, n_samples, host_sites=host)
        again = mck.site_probability_mc_cuda(p, offsets, counts, u, 1000, n_samples)
        want = mck.site_probability_mc_plain(p, offsets, counts, u, 1000, n_samples)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs.append(err)
        long_ptxas = _build.ptxas_usage(_build.cuda_library("mc", mck.kernel_defines(n_samples)),
                                        "mc_long_site_kernel")
        report.setdefault("long_kernel_ptxas", {})[n_samples] = long_ptxas
        log(f"[MC n_samples] {n_samples}: max|dsite_p| {err:.3e} repeat_identical {torch.equal(got, again)}; "
            f"mc_long_site_kernel ptxas {long_ptxas}")
        if err > MC_ATOL or not torch.equal(got, again) or not bool(torch.isfinite(got).all()):
            fail(f"MC at n_samples={n_samples}: the kernel disagrees with its plain version")
        same_as_parent(f"ragged n_samples={n_samples}", got, p, offsets, counts, u, 1000)
    report["max_abs_err"] = max(errs)

    # a columnar store of the demo's sites and one of LONG_SITE reads
    # (seeded reads, the demo's first sequence context), MC through the engine
    root = os.path.join(work_dir, "store")
    sites = demo_sites()
    norm = load_norm_factors(DEFAULT_NORM_PATH)
    mean, std = (v.astype(np.float32) for v in site_norm_vectors(norm, sites[0].sequence, 3))
    rng = np.random.default_rng(22)
    writer = ColumnarWriter(root, 3)
    for site in sites:
        writer.append_site(site.tx_id, site.tx_pos, site.sequence, site.features, site.read_ids)
    writer.append_site("LONGSITE", 1000, sites[0].sequence,
                       mean + std * rng.standard_normal(size=(LONG_SITE, 9), dtype=np.float32),
                       np.arange(LONG_SITE, dtype=np.int64))
    writer.finalize()
    weights, threshold, norm_path = PRETRAINED_CONFIGS["HCT116_RNA002"]
    with open(os.path.join(ROOT, "m6anet_tpu_torch", "models", "assets", "configs", "m6anet.toml"), "rb") as f:
        import tomllib

        model = load_model(tomllib.load(f), weights)
    # cuda_fused (f32, so its reads agree with the torch modules' to 1e-6)
    # against --backend torch: per read at P_ATOL, and per site against the
    # MC function of the torch run's reads over the CUDA backends' draws
    # (the torch backend draws in chunks of 64 iterations, so its own
    # site_p is another sample of the estimator)
    runs = {}
    for name, kw in (("cuda_fused", dict(backend="cuda_fused", precision="f32")), ("torch", dict(backend="torch"))):
        ds = ColumnarSiteDataset(root, min_reads=20, norm_path=norm_path)
        runs[name] = engine_run(logs, model, ds, os.path.join(work_dir, name), threshold, method="mc",
                                num_iterations=MC_ITERS, read_capacity=1 << 20, **kw)
        runs[name]["out"] = os.path.join(work_dir, name)
    launches = runs["cuda_fused"]["launches"]
    if launches["site_probability_mc_long"] < 1 or launches["site_probability_mc"] < 1:
        fail(f"MC over the store with a {LONG_SITE}-read site did not launch the long-site kernel: {launches}")
    kept = [s for s in sites if len(s.read_ids) >= 20]
    rows = (sum(len(s.read_ids) for s in kept) + LONG_SITE, len(kept) + 1)
    gaps = hold_outputs(runs["cuda_fused"]["out"], runs["torch"]["out"], threshold, P_ATOL["f32"], None,
                        "MC long site cuda_fused vs torch, per read", rows=rows)
    import pandas as pd

    site_csv = pd.read_csv(os.path.join(runs["cuda_fused"]["out"], "data.site_proba.csv"))
    indiv = pd.read_csv(os.path.join(runs["torch"]["out"], "data.indiv_proba.csv"))
    torch_p = torch.tensor(indiv.probability_modified.values, dtype=torch.float32, device="cuda")
    site_counts = torch.tensor(site_csv.n_reads.values, dtype=torch.int32, device="cuda")
    site_offsets = (torch.cumsum(site_counts, 0) - site_counts).to(torch.int32)
    u = torch.from_numpy(prng.shared_draws(0, MC_ITERS)).cuda()
    want = mck.site_probability_mc_plain(torch_p, site_offsets, site_counts, u, MC_ITERS)
    got = torch.tensor(site_csv.probability_modified.values, dtype=torch.float32, device="cuda")
    site_gap = float((got - want).abs().max())
    log(f"[MC long site e2e] cuda_fused {runs['cuda_fused']['path']} launches {launches}; site_p against the MC "
        f"function of the torch run's reads {site_gap:.3e} (tolerance {MC_TORCH_SITE_ATOL}); its largest site "
        f"{int(site_csv.n_reads.max())} reads")
    if site_gap > MC_TORCH_SITE_ATOL or int(site_csv.n_reads.max()) != LONG_SITE:
        fail("MC over a long site: cuda_fused disagrees with the torch run's reads")
    report["e2e"] = {"launches": launches, "batches": runs["cuda_fused"]["batches"], "site_vs_torch_reads": site_gap,
                     "reads_vs_torch": gaps}

    report["long_site"] = check_long_sites(older.get(mck.SAMPLES), older_lists, same_as_parent, peak_flops, peak_bw)
    report["max_abs_err"] = max(report["max_abs_err"], report["long_site"]["max_abs_err"])
    return report


def check_long_sites(older, older_lists, same_as_parent, peak_flops, peak_bw):
    """Phase 22's long-site shapes (_sweep.long_site_shapes) at T = 1000: the
    wrapper against the plain version, repeats (host and device lists)
    bit-identical, the older mc.cu's bits where staged; then, but at the
    2^23 - 1 site, mc_long_site_kernel alone beside the older one's
    (interleaved, CUDA events with the L2 flushed; torch.profiler device
    time), its bound (U once, each 32-byte sector of p the draws touch
    once: _sweep.long_site_sectors) and its latency floor: the same launch
    over the same list with long_from above every count, whose blocks read
    their list entry and then the count, two dependent loads from device
    memory, and stop.  mc_site_kernel at the
    production batch beside the older one's too."""
    from m6anet_tpu_torch.ops import mc_kernel as mck
    from m6anet_tpu_torch.ops import random as prng
    from m6anet_tpu_torch.scripts import _sweep

    u_host = prng.shared_draws(0, MC_ITERS)
    u = torch.from_numpy(u_host).cuda()
    lib, stream = mck.kernel_lib(), torch.cuda.current_stream().cuda_stream
    report, errs = {"n_iters": MC_ITERS, "shapes": {}}, []
    shapes = _sweep.long_site_shapes()
    # the wrapper at the 1,000,000-read site, as the engine calls it, and
    # its plain version; a 4 GB flush, whose ~1.2 ms outlasts the call's
    # host work (~0.1 ms, and more after a profiler session), so that the
    # events time the card
    p1, off1, cnt1 = (torch.from_numpy(a).cuda() for a in shapes["1M site"])
    host1 = shapes["1M site"][1:]
    report["ms"] = time_ms(lambda: mck.site_probability_mc_cuda(p1, off1, cnt1, u, MC_ITERS, host_sites=host1),
                           flush_bytes=4 << 30)
    report["plain_ms"] = time_ms(lambda: mck.site_probability_mc_plain(p1, off1, cnt1, u, MC_ITERS), reps=5)
    for name, arrays in shapes.items():
        p, offsets, counts = (torch.from_numpy(a).cuda() for a in arrays)
        host = arrays[1:]
        got = mck.site_probability_mc_cuda(p, offsets, counts, u, MC_ITERS, host_sites=host)
        again = mck.site_probability_mc_cuda(p, offsets, counts, u, MC_ITERS)
        want = mck.site_probability_mc_plain(p, offsets, counts, u, MC_ITERS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs.append(err)
        n_long = int((arrays[2] > mck.MAX_STAGED_READS).sum())
        log(f"[MC long shape] {name}: {len(arrays[2])} sites, {n_long} long, {len(arrays[0])} reads; "
            f"max|dsite_p| {err:.3e}; repeat identical {torch.equal(got, again)}")
        if err > MC_ATOL or not torch.equal(got, again) or not bool(torch.isfinite(got).all()):
            fail(f"MC {name}: the long-site kernel disagrees with its plain version, or with itself")
        same_as_parent(name, got, p, offsets, counts, u, MC_ITERS)
        if name == "2^23 - 1 site":
            continue
        # the long kernel alone, into a buffer of its own, with one scratch
        # for every launch (the kernel leaves its tickets zero: checked
        # after the timings), so that no fill is timed with it
        out = torch.zeros_like(got)
        listed = mck.long_sites(counts)
        scratch = mck.long_scratch(n_long, MC_ITERS, p.device)
        launches = {"new": lambda: mck.launch_long_sites(lib, p, offsets, counts, u, out, listed, MC_ITERS,
                                                         mck.SAMPLES, mck.MAX_STAGED_READS, scratch),
                    "floor": lambda: mck.launch_long_sites(lib, p, offsets, counts, u, out, listed, MC_ITERS,
                                                           mck.SAMPLES, 2**31 - 1, scratch)}
        if older is not None:
            launches["older"] = _sweep.long_site_launcher(older, older_lists, p, offsets, counts, u, out, MC_ITERS,
                                                          mck.MAX_STAGED_READS)
        for label, launch in launches.items():
            try:
                launch()
            except RuntimeError as exc:
                fail(f"MC {name}: the {label} long-site launch failed: {exc}")
        order = list(launches)
        times, clocks = _sweep.time_interleaved([launches[k] for k in order], reps=30)
        ms = dict(zip(order, (statistics.median(t) for t in times)))
        device = {}
        for label in ("new", "older"):
            # up to three profiler sessions: one may record none of the
            # kernel's launches (it did in a whole run of this script)
            for _ in range(3 if label in launches else 0):
                split = device_split_ms(launches[label])
                device[label] = next((v for k, v in split.items() if "mc_long_site_kernel" in k), None)
                if device[label] is not None:
                    break
        if int(torch.count_nonzero(scratch[1])):
            fail(f"MC {name}: mc_long_site_kernel left a ticket other than zero")
        # U once, each sector of p the draws touch once, and per long site
        # its list entry, offset, count and site_p
        sectors = _sweep.long_site_sectors(arrays[1], arrays[2], u_host)
        op_ms = n_long * MC_ITERS * (2 * mck.SAMPLES + 1) / peak_flops * 1e3
        byte_ms = (4 * mck.SAMPLES * MC_ITERS + 32 * sectors + 16 * n_long) / peak_bw * 1e3
        report["shapes"][name] = {
            "sites": len(arrays[2]), "long_sites": n_long, "reads": len(arrays[0]), "max_abs_err": err,
            "draws": n_long * MC_ITERS * mck.SAMPLES, "sectors": sectors,
            "ms": ms["new"], "older_ms": ms.get("older"), "device_ms": device.get("new"),
            "older_device_ms": device.get("older"), "latency_floor_ms": ms["floor"],
            "bound_ms": max(op_ms, byte_ms), "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "sm_clocks": clocks}
        log(f"[MC long timing] {name}: mc_long_site_kernel {ms['new']:.4f} ms (device {device.get('new')}), the "
            f"older {ms.get('older')} ms (device {device.get('older')}); latency floor {ms['floor']:.4f} ms, bound "
            f"{max(op_ms, byte_ms):.6f} ms ({sectors} sectors of p); SM clock {clocks}")
    timed = report["shapes"]
    report["max_abs_err"] = max(errs)
    report["wrapper_device_ms"] = device_split_ms(
        lambda: mck.site_probability_mc_cuda(p1, off1, cnt1, u, MC_ITERS, host_sites=host1))
    report["bound_ms"], report["bound_by"] = timed["1M site"]["bound_ms"], timed["1M site"]["bound_by"]
    growth = timed["production + long sites"]["ms"] - timed["long sites alone"]["ms"]
    log(f"[MC long timing] wrapper at the 1M site {report['ms']:.4f} ms (device {report['wrapper_device_ms']}), "
        f"plain {report['plain_ms']:.4f} ms; the production batch's 16,384 sites add {growth:.4f} ms to the long "
        f"sites alone")
    if older is not None:
        # mc_site_kernel's code is the older one's: its time at the
        # production batch beside the older build's, interleaved
        p, offsets, counts = (torch.from_numpy(a).cuda() for a in shapes["production + long sites"])
        keep = counts.shape[0] - len(mck.LONG_SITE_COUNTS)
        offsets, counts = offsets[:keep], counts[:keep]
        out = torch.empty(keep, dtype=torch.float32, device="cuda")
        max_count = int(counts.max())

        def staged(which):
            return lambda: which.cdll.mc_site_launch(p.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
                                                     u.data_ptr(), out.data_ptr(), keep, p.shape[0], MC_ITERS,
                                                     mck.SAMPLES, max_count, stream)

        times, clocks = _sweep.time_interleaved([staged(older), staged(lib)], reps=30)
        old_ms, new_ms = (statistics.median(t) for t in times)
        report["mc_site_kernel"] = {"ms": new_ms, "older_ms": old_ms, "ratio": new_ms / old_ms, "sm_clocks": clocks}
        log(f"[MC parent] mc_site_kernel at the production batch {new_ms:.4f} ms against the older build's "
            f"{old_ms:.4f} ms ({new_ms / old_ms:.4f}x)")
    return report


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke.py needs an NVIDIA card")
    from m6anet_tpu_torch.scripts import _sweep

    smi = _sweep.smi("name,power.limit")
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

    # ---- 2. build: the defaults and every library phases 21 and 22 take,
    # and beside them the older sources phases 21 and 23 compare with
    global PARENT
    PARENT = ParentBuild()
    built = _build.build_cuda(names=("fused_infer", "mc", "read_prob_tc"), variants=shape_variants())
    for name in ("fused_infer", "mc", "read_prob_tc"):
        if name not in built:
            fail(f"ops/csrc/{name}.cu was not built")
    for name, (path, seconds) in built.items():
        with open(path + ".log") as f:
            usage = [ln.strip() for ln in f if "registers" in ln]
        log(f"[build] {name}: {seconds:.1f} s; ptxas: {' | '.join(usage)}")

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        model = load_model(tomllib.load(f), PRETRAINED_CONFIGS["HCT116_RNA002"][0]).cuda()
    fp = fik.prepare_fused_params_t(model)

    # ---- 3. small ragged batch and ragged tails, 4. production batch
    rng = np.random.default_rng(0)
    tile = fik.read_tile_reads()
    log(f"[tails] phase A takes {tile} reads per block and tile")
    max_err = compare(fik, fp, make_batch(rng, 4096, 128, small_count(rng)), "small")
    tails = fik.ragged_tail_batches(tile)  # own seed: the batches below do not depend on them
    for batch in tails:
        max_err = max(max_err, compare(fik, fp, batch, f"tail {batch[0].shape[0]}"))
    full_batch = _sweep.production_batch()
    max_err = max(max_err, compare(fik, fp, full_batch, "full"))
    check_placement(fik, enc, fp, full_batch)

    # ---- 5. main path end to end, through the CLI
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    out = os.path.join(WORK_DIR, "HCT116_RNA002")
    # the CLI process starts with every launch count at 0 and reports the
    # batches and launches of its own run
    cli_wall, path, n_batches, launches = run_cli("HCT116_RNA002", out)
    log(f"[e2e] HCT116_RNA002: {cli_wall:.2f} s wall; {path}; {n_batches} batches; "
        f"kernel launches {launches}")
    if "backend=cuda_fused" not in path or "device=cuda" not in path or "precision=f32x3" not in path:
        fail(f"main path ran as {path!r}, not the fused CUDA kernels at f32x3")
    if (launches.get("fused_inference_t", 0) < 1 or launches.get("read_prob_tc_f32x3", 0) < 1
            or launches.get("site_reduce", 0) < 1 or n_batches < 1):
        fail("the main path did not launch the tensor-core kernel and phase B of fused_infer.cu")
    if "fused_inference" not in launches:
        fail("the engine did not report the launches of fused_inference")
    golden = {"f32x3": check_golden(out, label="e2e f32x3 (auto)")}
    # the f32 kernel, asked for by name, and the bf16 mode
    out_f32 = os.path.join(WORK_DIR, "HCT116_RNA002_f32")
    f32_wall, f32_path, f32_batches, f32_launches = run_cli("HCT116_RNA002", out_f32, ["--precision", "f32"])
    log(f"[e2e] --precision f32: {f32_wall:.2f} s wall; {f32_path}; {f32_batches} batches; "
        f"kernel launches {f32_launches}")
    if (re.search(r"precision=(\w+)", f32_path).group(1) != "f32" or f32_launches["fused_inference_t"] < 1
            or any(f32_launches[f"read_prob_tc_{m}"] for m in MODES)):
        fail("--precision f32 did not run the f32 kernel alone")
    golden["f32"] = check_golden(out_f32, label="e2e f32")
    out_bf16 = os.path.join(WORK_DIR, "HCT116_RNA002_bf16")
    bf16_wall, bf16_path, bf16_batches, bf16_launches = run_cli(
        "HCT116_RNA002", out_bf16, ["--precision", "bf16"])
    log(f"[e2e] --precision bf16: {bf16_wall:.2f} s wall; {bf16_path}; {bf16_batches} batches; "
        f"kernel launches {bf16_launches}")
    if "precision=bf16" not in bf16_path or bf16_launches["read_prob_tc_bf16"] < 1:
        fail("--precision bf16 did not launch the tensor-core kernel")
    golden["bf16"] = check_golden(out_bf16, label="e2e bf16", only_site=True)
    golden["bf16"]["indiv_vs_f32"] = compare_outputs(out_bf16, out_f32)["indiv"]
    log(f"[e2e bf16] per read against the f32 run: {golden['bf16']['indiv_vs_f32']:.3e} "
        f"(tolerance {BF16_INDIV_ATOL})")
    if golden["bf16"]["indiv_vs_f32"] > BF16_INDIV_ATOL:
        fail("e2e bf16: per-read p too far from the f32 run")
    for name in sorted(set(PRETRAINED_CONFIGS) - {"HCT116_RNA002"}):
        other = os.path.join(WORK_DIR, name)
        wall, _, _, other_launches = run_cli(name, other)
        check_finite(other, 101, 5595)
        log(f"[e2e] {name}: {wall:.2f} s wall, rows and values ok, launches {other_launches}")
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    # ---- 6. timing at the production batch
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in full_batch)
    args = (features, kmer, None, offsets, counts, THRESHOLD)
    host_kmer = fik.checked_kmer_ids(full_batch[1])  # the engine checks on its pack thread
    kernel_ms = time_ms(lambda: fik.fused_inference_t(fp, *args, host_kmer_ids=host_kmer))
    kernel_device_check_ms = time_ms(lambda: fik.fused_inference_t(fp, *args))
    plain_ms = time_ms(lambda: fik.fused_inference_t_plain(fp, *args))
    split = device_split_ms(lambda: fik.fused_inference_t(fp, *args, host_kmer_ids=host_kmer))
    log(f"[timing] f32 wrapper call: {kernel_ms:.4f} ms with host arrays, {kernel_device_check_ms:.4f} ms "
        f"checking on the device")
    sm_clock = _sweep.smi("clocks.sm")
    phase_a = _build.ptxas_usage(built["fused_infer"][0], "read_prob_kernel")
    log(f"[timing] device time per launch by kernel (torch.profiler, ms): {split or 'not measured'}")
    log(f"[timing] SM clock right after: {sm_clock}; phase A (read_prob_kernel) ptxas: {phase_a}")
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
        "launches": f32_launches["fused_inference_t"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the encoder and the per-site reductions",
        "launches_per_batch": f32_launches["fused_inference_t"] / f32_batches,
        "path": "inference --precision f32, exact (phase 5)",
        "ms_device_check": kernel_device_check_ms,
        "device_ms": split,
        "phase_a_ptxas": phase_a,
        "sm_clock_after_timing": sm_clock,
        "lane_group": fik.kernel_lib().lane_group,
        "grouped_launches_per_batch": f32_launches["read_prob_grouped"] / f32_batches,
    }]

    # ---- 7. the entry points of fused_infer.cu for TPU kernels #3 and #4
    entry_errs = compare_entries(fik, enc, site_ops, fp, make_batch(rng, 4096, 128, small_count(rng)), "entries small")
    for batch in [*tails, full_batch]:
        errs = compare_entries(fik, enc, site_ops, fp, batch, f"entries {batch[0].shape[0]}")
        entry_errs = {k: max(entry_errs[k], errs[k]) for k in entry_errs}

    # ---- 8. MC small ragged batch, 9. MC at the production batch
    mc_errs = []
    ragged = mck.ragged_mc_batch()
    p_s, off_s, cnt_s = (torch.from_numpy(a).cuda() for a in ragged)
    for n_iters in (1500, 257):
        u_small = torch.from_numpy(prng.shared_draws(0, n_iters)).cuda()
        mc_errs.append(compare_mc(mck, p_s, off_s, cnt_s, ragged[1:], u_small, n_iters, f"MC small T={n_iters}"))
    p_full = fik.fused_inference_t(fp, *args)[0]
    u_full = torch.from_numpy(prng.shared_draws(0, MC_ITERS)).cuda()
    full_sites = full_batch[2:]  # offsets and counts on the host
    mc_errs.append(compare_mc(mck, p_full, offsets, counts, full_sites, u_full, MC_ITERS, "MC full"))

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
    enc_wall, enc_path, enc_batches, enc_launches = run_cli(
        "HCT116_RNA002", out, ["--backend", "cuda", "--precision", "f32"])
    log(f"[cuda e2e] {enc_wall:.2f} s wall; {enc_path}; {enc_batches} batches; kernel launches {enc_launches}")
    if ("backend=cuda " not in enc_path or enc_launches.get("fused_read_probability", 0) < 1
            or any(enc_launches[f"read_prob_tc_{m}"] for m in MODES)):
        fail("--backend cuda --precision f32 did not launch the f32 encoder kernel alone")
    check_golden(out, label="cuda e2e")
    out = os.path.join(WORK_DIR, "encoder_f32x3")
    enc3_wall, enc3_path, enc3_batches, enc3_launches = run_cli(
        "HCT116_RNA002", out, ["--backend", "cuda", "--precision", "f32x3"])
    log(f"[cuda f32x3 e2e] {enc3_wall:.2f} s wall; {enc3_path}; {enc3_batches} batches; "
        f"kernel launches {enc3_launches}")
    if ("backend=cuda " not in enc3_path or "precision=f32x3" not in enc3_path
            or enc3_launches["fused_read_probability"] < 1 or enc3_launches["read_prob_tc_f32x3"] < 1):
        fail("--backend cuda --precision f32x3 did not launch the tensor-core kernel")
    golden["cuda f32x3"] = check_golden(out, label="cuda f32x3 e2e")
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    # ---- 11. timing of the MC kernel and the two entry points
    def mc_call(host_sites=None):
        return mck.site_probability_mc_cuda(p_full, offsets, counts, u_full, MC_ITERS, host_sites=host_sites)

    mc_ms = time_ms(lambda: mc_call(full_sites))  # as the engine calls it
    mc_device_checks_ms = time_ms(mc_call)
    mc_plain_ms = time_ms(lambda: mck.site_probability_mc_plain(p_full, offsets, counts, u_full, MC_ITERS), reps=5)
    mc_split = device_split_ms(lambda: mc_call(full_sites))
    mc_clock = _sweep.smi("clocks.sm")
    mc_ptxas = _build.ptxas_usage(built["mc"][0], "mc_site_kernel")
    mc_window = _sweep.draw_window(_sweep.sass_instructions(built["mc"][0], "mc_site_kernel"))
    log(f"[timing] MC device time per launch by kernel (torch.profiler, ms): {mc_split or 'not measured'}")
    log(f"[timing] MC wrapper call: {mc_ms:.4f} ms with host arrays, {mc_device_checks_ms:.4f} ms checking "
        f"on the device; SM clock right after: {mc_clock}; mc_site_kernel ptxas: {mc_ptxas}; "
        f"draws' SASS: {mc_window}")
    real = counts > 0
    n_real_sites, n_real_reads = int(real.sum()), int(counts.sum())
    mc_ops = n_real_sites * MC_ITERS * (20 + 1) + n_real_reads
    mc_bytes = 4 * n_real_reads + 4 * u_full.numel() + 8 * n_sites + 4 * n_sites
    mc_op_ms, mc_byte_ms = mc_ops / peak_flops * 1e3, mc_bytes / peak_bw * 1e3
    # the floors of mc.cu's design: models, printed apart from the timings
    hz = _sweep.max_sm_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    draws = n_real_sites * MC_ITERS * mck.SAMPLES
    passes, gathers = _sweep.gather_passes(full_batch[3], prng.shared_draws(0, MC_ITERS))
    log(json.dumps({"mc_floors": {
        "kernel": "mc_site_kernel", "draws": draws, "sms": sms, "max_sm_clock_hz": hz,
        "shared_memory_gather_ms": draws / (32 * sms * hz) * 1e3,
        "gather_passes_per_warp_load": passes / gathers,
        "shared_memory_gather_with_conflicts_ms": passes / (sms * hz) * 1e3,
        "instructions_per_draw": mc_window and mc_window["instructions_per_draw"],
        "issue_floor_ms": _sweep.issue_floor_ms(draws, mc_window, sms, hz),
    }}))
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
        "ms_device_checks": mc_device_checks_ms,
        "device_ms": mc_split,
        "mc_site_kernel_ptxas": mc_ptxas,
        "sm_clock_after_timing": mc_clock,
    })

    site_ids = site_ops.derive_site_ids(offsets, counts, n_reads, n_sites)
    enc_ms = time_ms(lambda: enc.fused_read_probability(fp, features, kmer, host_kmer_ids=host_kmer))
    enc_device_check_ms = time_ms(lambda: enc.fused_read_probability(fp, features, kmer))
    kmer_check_ms = host_check_ms(fik, full_batch[1])
    log(f"[timing] fused_read_probability (f32): {enc_ms:.4f} ms with host arrays, {enc_device_check_ms:.4f} ms "
        f"checking on the device; checked_kmer_ids on the host at {full_batch[1].size} ids: {kmer_check_ms:.4f} ms")
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
        "path": "inference --backend cuda --precision f32 (phase 10)",
        "ms_device_check": enc_device_check_ms,
        "host_kmer_check_ms": kmer_check_ms,
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

    # ---- 12. the f32x3 and bf16 modes: read_prob_tc.cu (phase A) and phase B
    # of fused_infer.cu against the plain versions; 13. their timing
    tc_tails = {mode: fik.ragged_tail_batches(fik.read_tile_reads(mode), seed=2) for mode in MODES}
    log(f"[modes] the tensor-core phase A's launch in each mode: "
        f"{fik.kernel_lib(precision='f32x3').plan}")
    for precision in ("f32", *MODES):
        check_span_fault(fik, fp, tc_tails["f32x3"][-1], precision)
    ragged = make_batch(rng, 4096, 128, small_count(rng))
    check_phase_b_alone(fik)
    for precision in ("f32", *MODES):
        for batch, label in ((full_batch, "production batch"), (ragged, "small ragged batch")):
            check_phase_b(fik, fp, batch, label, precision)
    tc_ptxas = {}
    mode_kernels = {}
    for mode in MODES:
        mode_err = compare(fik, fp, make_batch(rng, 4096, 128, small_count(rng)), f"{mode} small", mode)
        for batch in tc_tails[mode]:
            mode_err = max(mode_err, compare(fik, fp, batch, f"{mode} tail {batch[0].shape[0]}", mode))
        mode_err = max(mode_err, compare(fik, fp, full_batch, f"{mode} full", mode))
        check_placement(fik, enc, fp, full_batch, mode)
        for batch in (tc_tails[mode][-1], full_batch):
            errs = compare_entries(fik, enc, site_ops, fp, batch, f"{mode} entries {batch[0].shape[0]}", mode)
            mode_err = max(mode_err, *errs.values())
        tc_ptxas[mode] = _build.ptxas_usage(
            built["read_prob_tc"][0], f"read_prob_tc_kernelILi{fik.TC_MODES[mode]}E")
        mode_args = (*args, 20, mode)
        mode_ms = time_ms(lambda: fik.fused_inference_t(fp, *mode_args, host_kmer_ids=host_kmer))
        mode_device_check_ms = time_ms(lambda: fik.fused_inference_t(fp, *mode_args))
        mode_plain_ms = time_ms(lambda: fik.fused_inference_t_plain(fp, *mode_args))
        mode_phase_a_ms = time_ms(lambda: enc.fused_read_probability(fp, features, kmer, mode, host_kmer_ids=host_kmer))
        mode_phase_a_device_check_ms = time_ms(lambda: enc.fused_read_probability(fp, features, kmer, mode))
        mode_split = device_split_ms(lambda: fik.fused_inference_t(fp, *mode_args, host_kmer_ids=host_kmer))
        mode_clock = _sweep.smi("clocks.sm")
        ops = MODE_FLOP_PER_READ[mode]
        op_ms = max(n_reads * ops["f32"] / peak_flops, n_reads * ops["bf16"] / BF16_TENSOR_FLOPS) * 1e3
        mode_byte_ms = (bytes_moved - fp.packed.numel() * 4 + fp.tc.numel() * 4) / peak_bw * 1e3
        cli = {"f32x3": (launches, n_batches, "inference, exact, --precision auto = f32x3 (phase 5: the main path)"),
               "bf16": (bf16_launches, bf16_batches, "inference --precision bf16, exact (phase 5)")}[mode]
        log(f"[timing {mode}] wrapper {mode_ms:.4f} ms with host arrays, {mode_device_check_ms:.4f} ms checking on "
            f"the device; phase A alone {mode_phase_a_ms:.4f} / {mode_phase_a_device_check_ms:.4f} ms; plain "
            f"{mode_plain_ms:.4f} ms; device time per launch (torch.profiler, ms): {mode_split or 'not measured'}; "
            f"read_prob_tc_kernel ptxas: {tc_ptxas[mode]}; SM clock right after: {mode_clock}")
        mode_kernels[mode] = {
            "name": f"fused_inference_t[{mode}]",
            "route": "cuda",
            "source": "m6anet_tpu_torch/ops/csrc/read_prob_tc.cu",
            "replaces": _replaces("read_prob_tc.cu"),
            "launches": cli[0][f"read_prob_tc_{mode}"],
            "max_abs_err": mode_err,
            "ms": mode_ms,
            "plain_ms": mode_plain_ms,
            "bound_ms": max(op_ms, mode_byte_ms),
            "bound_by": "operations" if op_ms >= mode_byte_ms else "bytes",
            "library_ms": None,
            "library_note": "no single PyTorch call computes the encoder in this precision",
            "launches_per_batch": cli[0][f"read_prob_tc_{mode}"] / cli[1],
            "path": cli[2],
            "kernels": "read_prob_tc_kernel (phase A) + site_reduce_kernel of fused_infer.cu (phase B)",
            "ms_device_check": mode_device_check_ms,
            "phase_a_ms": mode_phase_a_ms,
            "phase_a_ms_device_check": mode_phase_a_device_check_ms,
            "device_ms": mode_split,
            "read_prob_tc_ptxas": tc_ptxas[mode],
            "read_prob_tc_launch": fik.kernel_lib(precision=mode).plan[mode],
            "sm_clock_after_timing": mode_clock,
            "golden_max_errors": golden[mode],
        }

    # phase B alone on the f32x3 p of the production batch (the main path's),
    # and a library yardstick
    p_tc = fik.fused_inference_t(fp, *args, 20, "f32x3", host_kmer_ids=host_kmer)[0]
    n_real_reads = int(counts.sum())
    phase_b_ms = time_ms(lambda: fik.site_reduce(p_tc, offsets, counts, THRESHOLD))
    phase_b_plain_ms = time_ms(lambda: fik.site_reduce_plain(p_tc, offsets, counts, THRESHOLD))
    one_minus = 1.0 - p_tc[:n_real_reads]
    segment_ms = time_ms(lambda: torch.segment_reduce(one_minus, "sum", lengths=counts))
    phase_b_split = device_split_ms(lambda: fik.site_reduce(p_tc, offsets, counts, THRESHOLD))
    phase_b_ptxas = _build.ptxas_usage(built["fused_infer"][0], "site_reduce_kernel")
    # the reads of the spans once, offsets and counts in, site_p and mod_ratio out
    phase_b_bytes = 4 * n_real_reads + 16 * n_sites
    phase_b_bound_ms = phase_b_bytes / peak_bw * 1e3
    log(f"[timing phase B] alone {phase_b_ms:.4f} ms (bound {phase_b_bound_ms:.4f} ms, {phase_b_bytes} bytes), "
        f"plain {phase_b_plain_ms:.4f} ms, torch.segment_reduce of 1 - p (the sums alone) {segment_ms:.4f} ms; "
        f"device time per launch (torch.profiler, ms): {phase_b_split or 'not measured'}; "
        f"site_reduce_kernel ptxas: {phase_b_ptxas}")
    for mode in MODES:
        mode_kernels[mode].update(phase_b_bound_ms=phase_b_bound_ms, phase_b_bytes=phase_b_bytes)
        kernels.append(mode_kernels[mode])
    kernels.append({
        "name": "site_reduce_kernel",
        "route": "cuda",
        "source": "m6anet_tpu_torch/ops/csrc/fused_infer.cu",
        "replaces": _replaces("fused_infer.cu", "site_reduce_launch"),
        "launches": launches["site_reduce"],
        "max_abs_err": 0.0,  # the same bits as the plain version, or the run has failed
        "ms": phase_b_ms,
        "plain_ms": phase_b_plain_ms,
        "bound_ms": phase_b_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the segment mean, the noisy-OR power and the hit "
                        "ratio; torch.segment_reduce of 1 - p computes the sums alone (segment_reduce_ms)",
        "segment_reduce_ms": segment_ms,
        "bound_share": phase_b_bound_ms / phase_b_ms,
        "launches_per_batch": launches["site_reduce"] / n_batches,
        "path": "inference, exact, --precision auto = f32x3 (phase 5: the main path), after read_prob_tc_kernel",
        "device_ms": phase_b_split,
        "site_reduce_kernel_ptxas": phase_b_ptxas,
    })
    kernels.append(time_read_prob_tail(full_batch, peak_flops, peak_bw))

    # ---- 14. T1: the train step on the card against the CPU
    from m6anet_tpu_torch.models.convert import params_from_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.utils.treeio import load_tree

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        config = tomllib.load(f)
    starts = {
        "HCT116_RNA002": params_from_jax(load_tree(PRETRAINED_CONFIGS["HCT116_RNA002"][0])),
        "init seed 0": MILModel(config).init(torch.Generator().manual_seed(0)).state_dict(),
    }
    batches = train_batches(0, TRAIN_STEPS)
    training = {"steps": TRAIN_STEPS, "sites": TRAIN_SITES, "reads_per_site": TRAIN_READS, "lr": TRAIN_LR,
                "weight_decay": TRAIN_WD, "clip_grad": TRAIN_CLIP}
    for label, state in starts.items():
        training[label] = check_train_start(config, state, label, batches)
    training["determinism"] = {"default": run_determinism_probe(False), "deterministic": run_determinism_probe(True)}
    log(f"[T1 determinism] {training['determinism']}")
    training["timing"] = time_train_steps(config, starts["HCT116_RNA002"], batches)
    log(f"[T1 timing] {training['timing']}")

    # ---- 15. T2: the train CLI on the card, then its model through inference
    os.makedirs(WORK_DIR)
    train_wall, save_dir, train_results = train_cli(WORK_DIR)
    log(f"[T2] train CLI: {train_wall:.2f} s wall; train losses {train_results['train_results.json']['avg_loss']}, "
        f"val losses {train_results['val_results.json']['avg_loss']}")
    trained = ["--model_state_dict", os.path.join(save_dir, "avg_loss.npz"), "--precision", "f32"]
    out_card, out_cpu = os.path.join(WORK_DIR, "trained_card"), os.path.join(WORK_DIR, "trained_cpu")
    t2_wall, t2_path, t2_batches, t2_launches = run_cli("HCT116_RNA002", out_card, trained)
    if ("backend=cuda_fused" not in t2_path or "precision=f32" not in t2_path
            or t2_launches["fused_inference_t"] < 1 or t2_launches["site_reduce"] < 1):
        fail(f"the trained model's inference ran as {t2_path!r} with launches {t2_launches}")
    cpu_wall, cpu_path, _, _ = run_cli("HCT116_RNA002", out_cpu, [*trained, "--device", "cpu"])
    check_finite(out_card, 101, 5595)
    t2_errs = compare_outputs(out_card, out_cpu)
    log(f"[T2] trained model's inference: card {t2_wall:.2f} s ({t2_path}; launches {t2_launches}), CPU "
        f"{cpu_wall:.2f} s; card vs CPU {t2_errs} (tolerances {GOLDEN_ATOL})")
    if any(t2_errs[k] > GOLDEN_ATOL[k] for k in GOLDEN_ATOL):
        fail("the trained model's inference on the card is too far from the CPU's")
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    training["cli"] = {
        "train_wall_s": train_wall, "train_losses": train_results["train_results.json"]["avg_loss"],
        "val_losses": train_results["val_results.json"]["avg_loss"],
        "inference_card_vs_cpu": t2_errs, "inference_launches": t2_launches, "inference_batches": t2_batches,
        "inference_path": t2_path,
    }

    # ---- 16. the four released models, 17. the generic model path
    logs = LogLines()
    os.makedirs(WORK_DIR)
    models = check_models(logs, WORK_DIR, full_batch)
    os.makedirs(WORK_DIR, exist_ok=True)
    generic = check_generic(logs, WORK_DIR)
    # each kernel's launches per model, from the phase-16 run of its path
    by_kernel = {
        "fused_inference_t": ("f32", "fused_inference_t"), "site_probability_mc": ("mc", "site_probability_mc"),
        "fused_read_probability": ("cuda f32", "fused_read_probability"),
        "fused_inference": ("f32x3", "fused_inference"),
        "fused_inference_t[f32x3]": ("f32x3", "read_prob_tc_f32x3"),
        "fused_inference_t[bf16]": ("bf16", "read_prob_tc_bf16"), "site_reduce_kernel": ("f32x3", "site_reduce"),
        "read_prob_tail": ("torch", "read_prob_tail"),
    }
    for entry in kernels:
        run, counter = by_kernel[entry["name"]]
        entry["launches_by_model"] = {
            name: {"run": run, "launches": rep["runs"][run]["launches"][counter],
                   "batches": rep["runs"][run]["batches"]} for name, rep in models.items()}

    # ---- 18. the columnar store, 19. shards and processes
    os.makedirs(WORK_DIR, exist_ok=True)
    columnar, demo_store = check_columnar(logs, os.path.join(WORK_DIR, "columnar"))
    shards = check_shards(logs, os.path.join(WORK_DIR, "shards"), demo_store)
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    # ---- 20. eventalign.txt to calls with the port alone
    pipeline = check_pipeline(logs, os.path.join(WORK_DIR, "pipeline"), smi)

    # ---- 21. other widths of the production architecture, 22. MC shapes,
    # 23. past the widths of the kernels' fast plans
    os.makedirs(WORK_DIR, exist_ok=True)
    widths = check_widths(logs, os.path.join(WORK_DIR, "widths"), full_batch, peak_flops)
    mc_shapes = check_mc_shapes(logs, os.path.join(WORK_DIR, "mc_shapes"), peak_flops, peak_bw)
    past = check_past_envelope(logs, os.path.join(WORK_DIR, "past"), full_batch, peak_flops, peak_bw)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    width_runs = {"fused_inference_t": "f32", "fused_read_probability": "f32", "fused_inference_t[f32x3]": "f32x3",
                  "fused_inference_t[bf16]": "bf16"}
    for entry in kernels:
        if entry["name"] in width_runs:
            precision = width_runs[entry["name"]]
            entry["widths"] = {name: {"widths": rep["widths"], "phase_a_ms": rep["phase_a_ms"][precision],
                                      "f32_bound_ms": rep["f32_bound_ms"], "max_abs_err": rep["max_abs_err"][precision]}
                               for name, rep in widths.items() if name in WIDTHS}
    trained = widths["W3 trained"]
    kernels[[e["name"] for e in kernels].index("fused_inference_t[f32x3]")]["launches_w3_trained"] = {
        "launches": trained["launches"]["read_prob_tc_f32x3"], "batches": trained["batches"],
        "path": "inference --model_config (W3) --model_state_dict, auto (phase 21)"}
    long_site = mc_shapes["long_site"]
    kernels.append({
        "name": "site_probability_mc[long sites]",
        "route": "cuda",
        "source": "m6anet_tpu_torch/ops/csrc/mc.cu",
        "replaces": _replaces("mc.cu"),
        "launches": mc_shapes["e2e"]["launches"]["site_probability_mc_long"],
        "max_abs_err": mc_shapes["max_abs_err"],
        "ms": long_site["ms"],
        "plain_ms": long_site["plain_ms"],
        "bound_ms": long_site["bound_ms"],
        "bound_by": long_site["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the sampled noisy-OR",
        "launches_per_batch": mc_shapes["e2e"]["launches"]["site_probability_mc_long"] / mc_shapes["e2e"]["batches"],
        "path": f"run_inference, MC, over a columnar store with a {LONG_SITE}-read site (phase 22); ms: the "
                "wrapper (mc_site_kernel and mc_long_site_kernel) at one 1,000,000-read site, T = 1000",
        "kernels": "mc_site_kernel (the short sites) + mc_long_site_kernel",
        "device_ms": long_site["wrapper_device_ms"],
        "shapes": long_site["shapes"],
        "shapes_note": "mc_long_site_kernel alone at T = 1000 (ms: CUDA events, L2 flushed; device_ms: "
                       "torch.profiler), beside the older mc.cu's where staged; bound: U once and each 32-byte "
                       "sector of p the draws touch (sectors); latency_floor_ms: the same launch stopping after "
                       "each block's list entry and count",
        "mc_site_kernel_vs_older": long_site.get("mc_site_kernel"),
    })

    # the wide plans' kernels: launches from phase 23's W12 run of each
    # precision (f32x3 also from W9's trained model), times, plain versions
    # and the cuBLAS chain at W12 (1,048,576 reads), errors over every width
    # where the precision's phase A is wide, each such width's times beside
    # the older kernel's (where staged) and the cuBLAS chain's
    w12, w12_engine = past["W12"], past["W12 engine"]
    library_note = {"f32": "the cuBLAS chain x @ W1^T + b1, relu, @ W2^T + b2, relu, . w3 + b3, sigmoid in f32 "
                           "(TF32 off) on inputs gathered beforehand",
                    "f32x3": "none: no PyTorch call computes f32x3's split products",
                    "bf16": "the same cuBLAS chain in bf16"}
    for precision, (name, source, kernel) in {
            "f32": ("fused_inference_t[f32, wide plan]", "fused_infer.cu", "read_prob_wide_kernel"),
            "f32x3": ("fused_inference_t[f32x3, wide plan]", "read_prob_tc.cu", "read_prob_tc_wide_kernel<1>"),
            "bf16": ("fused_inference_t[bf16, wide plan]", "read_prob_tc.cu", "read_prob_tc_wide_kernel<2>")}.items():
        run = w12_engine[precision]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"m6anet_tpu_torch/ops/csrc/{source}",
            "replaces": _replaces(source),
            "launches": run["launches"][f"read_prob_wide_{precision}"],
            "max_abs_err": max(rep["max_abs_err"][precision] for key, rep in past.items()
                               if key in PAST_WIDTHS and "wide" in rep["ptxas"][precision]["kernel"]),
            "ms": w12["phase_a_ms"][precision],
            "plain_ms": w12["plain_ms"][precision],
            "bound_ms": w12["bound_ms"][precision],
            "bound_by": w12["bound_by"][precision],
            "library_ms": None if precision == "f32x3" else w12["cublas_ms"][precision],
            "library_note": library_note[precision],
            "older_ms": (w12["parent"] or {}).get(precision, {}).get("older_ms"),
            "launches_per_batch": run["launches"][f"read_prob_wide_{precision}"] / run["batches"],
            "path": f"run_inference, cuda_fused --precision {precision}, a seeded W12 model {PAST_WIDTHS['W12']} "
                    f"(phase 23); ms: phase A alone at W12, {w12['reads']} reads",
            "kernel": kernel,
            "ptxas": w12["ptxas"][precision],
            "widths": {key: {"widths": rep["widths"], "phase_a_ms": rep["phase_a_ms"][precision],
                             "bound_ms": rep["bound_ms"][precision], "max_abs_err": rep["max_abs_err"][precision],
                             "older_ms": (rep["parent"] or {}).get(precision, {}).get("older_ms"),
                             "library_ms": None if precision == "f32x3" else rep["cublas_ms"][precision]}
                       for key, rep in past.items()
                       if key in PAST_WIDTHS and "wide" in rep["ptxas"][precision]["kernel"]},
        })
    kernels[-2]["launches_w9_trained"] = {
        "launches": past["W9 trained"]["launches"]["read_prob_wide_f32x3"], "batches": past["W9 trained"]["batches"],
        "path": "inference --model_config (W9) --model_state_dict, auto (phase 23)"}

    for precision in P_ATOL:
        check_close_share(precision)
    log(json.dumps({"models": {
        name: {"threshold": rep["threshold"], "norm_factors": rep["norm_factors"],
               "wall_s": {run: r["wall_s"] for run, r in rep["runs"].items()},
               "stages": {run: r["stages"] for run, r in rep["runs"].items()},
               "errors": rep["errors"], "kernel_vs_plain": rep["kernel_vs_plain"]}
        for name, rep in models.items()}}))
    log(json.dumps({"generic": {
        name: ({k: v for k, v in rep.items() if k not in ("card", "cpu")}
               | {"card_wall_s": rep["card"]["wall_s"], "cpu_wall_s": rep["cpu"]["wall_s"],
                  "card_path": rep["card"]["path"], "card_stages": rep["card"]["stages"]}
               if "card" in rep else {k: v for k, v in rep.items() if k not in ("card_losses", "cpu_losses")})
        for name, rep in generic.items()}}))
    log(json.dumps({"columnar": columnar}))
    log(json.dumps({"shards": shards}))
    log(json.dumps({"pipeline": pipeline}))
    log(json.dumps({"widths": widths}))
    log(json.dumps({"mc_shapes": mc_shapes}))
    log(json.dumps({"past_envelope": past}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"training": training}))
    log(json.dumps({
        "timing": {
            "reads": n_reads, "sites": n_sites, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms,
            "reads_per_s": n_reads / kernel_ms * 1e3, "demo_cli_wall_s": cli_wall,
            "mc_ms": mc_ms, "mc_sites_per_s": n_sites / mc_ms * 1e3, "mc_iters": MC_ITERS,
            "sm_clock_after_timing": sm_clock,
            "mc_demo_cli_wall_s": mc_wall, "mc_demo_path": mc_path,
            "cuda_backend_demo_cli_wall_s": enc_wall, "cuda_backend_demo_path": enc_path,
            "real_reads": int(counts.sum()), "phase_b_ms": phase_b_ms, "host_kmer_check_ms": kmer_check_ms,
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
