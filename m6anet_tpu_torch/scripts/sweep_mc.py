"""Sweep the constants of ``ops/csrc/mc.cu`` on one card.

    python -m m6anet_tpu_torch.scripts.sweep_mc [--reference OTHER.cu] [--out FILE.json]

The kernel's shape is five constants of its source: threads per block
(``kThreads``), iterations whose draws a thread holds in registers
(``kIters``), blocks per SM asked of ``__launch_bounds__`` (``kMinBlocks``,
which caps the registers a thread may take), the sites staged together
between two barriers (``kGroup``) and the sites a thread runs side by side
over the same draws (``kTogether``).  For each set in ``VARIANTS`` the script builds a temporary copy of the source
with those constants rewritten, and reports:

* the registers, spills and shared memory ptxas gives ``mc_site_kernel``,
  the static count of its SASS instructions by opcode (``cuobjdump``), and
  the instructions between its first and last ``FADD.RZ`` (the unrolled
  draws of one site) per draw, with the ``LDG`` and ``F2I`` among them;
* whether site_p is bit-identical to the source as it stands and to
  ``--reference`` (another version of the file, such as an earlier
  commit's; its ``mc_site_launch`` may lack the ``n_reads`` argument), at
  the production batch of ``_sweep.production_batch`` (16,384 sites, read
  counts ``clip(gamma(2, 30), 20, 1000)``, p from the fused kernel with the
  HCT116_RNA002 model's weights, 1,000 iterations) and on
  ``mc_kernel.ragged_mc_batch`` at 1,500 iterations, and its largest
  difference from the plain PyTorch version on both;
* its time per launch at the production batch: the median of CUDA-event
  timings over two interleaved rounds, with the L2 cache flushed before each
  launch, beside two floors of the design (``_sweep.py``): the
  shared-memory gathers (one warp-wide pass a clock per SM, with the passes
  that bank conflicts add counted on the host from the batch's counts and
  U) and the instructions issued for the draws (128 lanes a clock per SM).

Beside them it times the ``ABLATIONS``: the source as checked in with one
part left out (the shared-memory loads, the FMUL, expf, half the draws),
which tells what each part costs; their site_p is not checked.

The long-site kernel's shape is three more constants: its threads a block
(``kLongThreads``), the iterations a thread takes (``kLongIters``) and the
values a thread of a site's last block loads at once for each of its f64
chains (``kLongLoads``).  For each set in ``LONG_VARIANTS`` (and
``--reference``, whose long-site launch may scan the counts, as the older
version's did) it reports ``mc_long_site_kernel``'s registers and spills, site_p (both
kernels) against the checked-in source's bits and the plain version on
``_sweep.long_site_shapes``' three timed batches (one 1,000,000-read site,
the production batch with three long sites after it, 18 sites of 57,345
reads; T = 1000), and the long kernel's time alone on each, interleaved
with the L2 flushed.  Every variant must give the checked-in bits.

Everything is built in a temporary directory that is removed at the end.
Prints one JSON line per build, the card's ``nvidia-smi`` name and power
limit, and the SM clock read after each round; ``--out`` also writes them to
a file.  Needs one NVIDIA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import tomllib

import torch

from ..constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
from ..models import load_model
from ..ops import _build, _native
from ..ops import fused_infer_kernel as fik
from ..ops import mc_kernel
from ..ops import random as prng
from ._sweep import (
    SITES, bind_mc, draw_window, gather_passes, issue_floor_ms, long_site_launcher, long_site_shapes,
    max_sm_hz, mc_lists_sites, mc_site_p, production_batch, same_bits, sass_counts, sass_instructions, smi,
    time_interleaved, variant_source,
)

# (threads, iterations held, blocks per SM asked, sites staged together,
# sites run side by side)
VARIANTS = [
    (256, 4, 2, 8, 1), (256, 4, 2, 8, 2), (256, 4, 2, 8, 4),
    (256, 4, 2, 1, 1), (256, 4, 2, 4, 2), (256, 4, 2, 16, 2), (256, 4, 1, 8, 2),
]
CONSTANTS = ("kThreads", "kIters", "kMinBlocks", "kGroup", "kTogether")
# builds that leave a part of the kernel out, timed beside the others to show
# what that part costs; their site_p is not checked (it is not the function)
ABLATIONS = [
    ("without the shared-memory loads", "s[q][i] += load_shared(bits * 4u + bias[q]);",
     "s[q][i] += __uint_as_float(bits * 4u + bias[q]);"),
    ("without the FMUL", "const float x = __fmul_rn(draws[i][j], cf[q]);", "const float x = draws[i][j];"),
    ("without expf", "e[i] = expf(s[q][i]);", "e[i] = s[q][i];"),
    ("half the draws", "for (int j = 0; j < kSamples; ++j) {", "for (int j = 0; j < kSamples / 2; ++j) {"),
]
# mc_long_site_kernel's (threads a block, iterations a thread, loads a chain
# at once in a site's last block); the first is the checked-in set
LONG_VARIANTS = [
    (64, 1, 4), (32, 1, 4), (128, 1, 4), (256, 1, 4), (32, 2, 4), (64, 2, 4), (64, 4, 4), (64, 1, 8), (64, 1, 16),
]
LONG_CONSTANTS = ("kLongThreads", "kLongIters", "kLongLoads")
LONG_SHAPES = ("1M site", "production + long sites", "18 x 57345")
OPCODES = ("LDS", "LDG", "STS", "F2I", "FADD", "FMUL", "IMAD", "IMNMX", "BAR", "SHFL", "MUFU")
ITERS, RAGGED_ITERS = 1000, 1500
REPS = 30  # timed launches per build and round


def production_batch_p(fp):
    """p (from the fused kernel), offsets and counts of the production batch
    (``_sweep.production_batch``), on the card, and the counts on the host."""
    batch = production_batch()
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    threshold = PRETRAINED_CONFIGS["HCT116_RNA002"][1]
    p = fik.fused_inference_t(fp, features, kmer, None, offsets, counts, threshold)[0]
    return p, offsets, counts, batch[3]


def sweep_long(long_builds, long_libs, card):
    """The long-site variants (``long_builds``: (label, source) with the
    checked-in source first; ``long_libs`` their libraries) on
    ``LONG_SHAPES`` at ``ITERS``: one JSON line each."""
    u = torch.from_numpy(prng.shared_draws(0, ITERS)).cuda()
    shapes = {name: tuple(torch.from_numpy(a).cuda() for a in arrays)
              for name, arrays in long_site_shapes().items() if name in LONG_SHAPES}
    plain = {name: mc_kernel.site_probability_mc_plain(p, o, c, u, ITERS) for name, (p, o, c) in shapes.items()}
    rows, launches = [], {name: [] for name in shapes}
    for (label, source), lib_path in zip(long_builds, long_libs):
        lists = mc_lists_sites(source)
        lib = bind_mc(lib_path, lists)
        row = {"build": label, "ptxas": _build.ptxas_usage(lib_path, "mc_long_site_kernel"), "site_p": {},
               "repeat_identical": True}
        for name, (p, o, c) in shapes.items():
            first = mc_site_p(lib, lists, p, o, c, u, ITERS)
            again = mc_site_p(lib, lists, p, o, c, u, ITERS)
            torch.cuda.synchronize()
            row["site_p"][name] = first
            row["repeat_identical"] = row["repeat_identical"] and torch.equal(first, again)
            out = torch.zeros_like(first)
            launches[name].append(long_site_launcher(lib, lists, p, o, c, u, out, ITERS, mc_kernel.MAX_STAGED_READS))
        rows.append(row)
    checked_in = rows[0]["site_p"]
    results = []
    times = {name: time_interleaved(fns, REPS) for name, fns in launches.items()}
    for k, row in enumerate(rows):
        result = {
            "build": row["build"], "ptxas": row["ptxas"],
            "ms": {name: statistics.median(times[name][0][k]) for name in shapes},
            "sm_clocks": {name: times[name][1] for name in shapes},
            "max_abs_err_vs_plain": {name: float((v - plain[name]).abs().max()) for name, v in row["site_p"].items()},
            "repeat_identical": row["repeat_identical"],
            "bit_identical_to_checked_in": {name: same_bits(v, checked_in[name]) for name, v in row["site_p"].items()},
            "card": card,
        }
        results.append(result)
        print(json.dumps(result), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", help="another mc.cu to build and compare with")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAILED: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        model = load_model(tomllib.load(f), PRETRAINED_CONFIGS["HCT116_RNA002"][0]).cuda()
    fp = fik.prepare_fused_params_t(model)
    p, offsets, counts, host_counts = production_batch_p(fp)
    u_np = prng.shared_draws(0, ITERS)
    u = torch.from_numpy(u_np).cuda()
    rp, roffsets, rcounts = (torch.from_numpy(a).cuda() for a in mc_kernel.ragged_mc_batch())
    ru = torch.from_numpy(prng.shared_draws(1, RAGGED_ITERS)).cuda()
    cases = [
        ("production", p, offsets, counts, u, ITERS, int(host_counts.max())),
        ("ragged", rp, roffsets, rcounts, ru, RAGGED_ITERS, int(rcounts.max())),
    ]
    plain = {name: mc_kernel.site_probability_mc_plain(pp, o, c, uu, t) for name, pp, o, c, uu, t, _ in cases}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_hz = max_sm_hz()
    draws = int((host_counts > 0).sum()) * ITERS * mc_kernel.SAMPLES

    tmp = tempfile.mkdtemp(prefix="sweep_mc_")
    try:
        source = os.path.join(_build.CSRC_DIR, "mc.cu")
        with open(source) as f:
            text = f.read()
        builds = [("as checked in", source)]
        if args.reference:
            builds.insert(0, ("reference", os.path.abspath(args.reference)))
        for values in VARIANTS:
            path = os.path.join(tmp, "mc_t{}_i{}_b{}_g{}_s{}.cu".format(*values))
            with open(path, "w") as f:
                f.write(variant_source(text, CONSTANTS, values, "mc.cu"))
            builds.append((dict(zip(CONSTANTS, values)), path))
        for n, (label, old, new) in enumerate(ABLATIONS):
            if text.count(old) != 1:
                raise SystemExit(f"mc.cu has no single {old!r} to leave out")
            path = os.path.join(tmp, f"mc_ablation_{n}.cu")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            builds.append((f"ablation: {label}", path))
        long_builds = [("as checked in", source)] + ([("reference", builds[0][1])] if args.reference else [])
        for values in LONG_VARIANTS[1:]:
            path = os.path.join(tmp, "mc_long_t{}_i{}_l{}.cu".format(*values))
            with open(path, "w") as f:
                f.write(variant_source(text, LONG_CONSTANTS, values, "mc.cu"))
            long_builds.append((dict(zip(LONG_CONSTANTS, values)), path))
        command = [_build.nvcc_path(), *_build.NVCC_FLAGS]
        sources = [path for _, path in builds]
        sources += [path for _, path in long_builds if path not in sources]
        library = dict(zip(sources, _build.build_shared_libraries([(path, command) for path in sources], out_dir=tmp)))
        libs = [library[path] for _, path in builds]
        long_results = sweep_long(long_builds, [library[path] for _, path in long_builds], card)

        rows = []
        for (label, source_path), lib_path in zip(builds, libs):
            lib = _native.declare(lib_path, "mc")
            # an older source's launch takes no n_reads (the 7th argument)
            with open(source_path) as f:
                takes_n_reads = "int64_t n_reads" in f.read()
            if not takes_n_reads:
                lib.mc_site_launch.argtypes = [t for i, t in enumerate(lib.mc_site_launch.argtypes) if i != 6]
            out = {}

            def launcher(case, lib=lib, takes_n_reads=takes_n_reads):
                _, pp, o, c, uu, t, max_count = case
                site_p = torch.empty(c.shape[0], dtype=torch.float32, device="cuda")
                n_reads = [pp.shape[0]] if takes_n_reads else []

                def launch():
                    err = lib.mc_site_launch(
                        pp.data_ptr(), o.data_ptr(), c.data_ptr(), uu.data_ptr(), site_p.data_ptr(),
                        c.shape[0], *n_reads, t, mc_kernel.SAMPLES, max_count,
                        torch.cuda.current_stream().cuda_stream,
                    )
                    if err != 0:
                        raise RuntimeError(f"mc_site_launch failed with CUDA error {err}")

                return launch, site_p

            for case in cases:
                launch, site_p = launcher(case)
                launch()
                first = site_p.clone()
                launch()
                torch.cuda.synchronize()
                out[case[0]] = (first, torch.equal(first, site_p))
            instructions = sass_instructions(lib_path, "mc_site_kernel")
            rows.append({
                "build": label, "launch": launcher(cases[0])[0],
                "ptxas": _build.ptxas_usage(lib_path, "mc_site_kernel"),
                "sass": sass_counts(instructions, OPCODES, (".RZ",)),
                "draw_window": draw_window(instructions),
                "site_p": {name: v[0] for name, v in out.items()},
                "repeat_identical": all(v[1] for v in out.values()),
                "max_abs_err_vs_plain": {name: float((v[0] - plain[name]).abs().max()) for name, v in out.items()},
                "finite": all(bool(torch.isfinite(v[0]).all()) for v in out.values()),
            })
        checked_in = next(r["site_p"] for r in rows if r["build"] == "as checked in")
        reference = rows[0]["site_p"] if args.reference else None
        for row in rows:
            row["bit_identical_to_checked_in"] = {k: torch.equal(v, checked_in[k]) for k, v in row["site_p"].items()}
            if reference is not None:
                row["bit_identical_to_reference"] = {k: torch.equal(v, reference[k]) for k, v in row["site_p"].items()}

        times, clocks = time_interleaved([row["launch"] for row in rows], REPS)
        results = []
        passes, gathers = gather_passes(host_counts, u_np)
        for row, row_times in zip(rows, times):
            half = len(row_times) // 2
            ms = statistics.median(row_times)
            window = row["draw_window"]
            result = {
                "build": row["build"], "ptxas": row["ptxas"], "sass_static_counts": row["sass"],
                "draw_window": window,
                "ms": ms, "ms_by_round": [statistics.median(row_times[:half]), statistics.median(row_times[half:])],
                "gather_passes_per_warp_load": passes / gathers,
                "gather_floor_ms": passes / (sms * max_hz) * 1e3,
                "issue_floor_ms": issue_floor_ms(draws, window, sms, max_hz),
                "max_abs_err_vs_plain": row["max_abs_err_vs_plain"], "finite": row["finite"],
                "repeat_identical": row["repeat_identical"],
                "bit_identical_to_checked_in": row["bit_identical_to_checked_in"],
            }
            if reference is not None:
                result["bit_identical_to_reference"] = row["bit_identical_to_reference"]
            results.append(result)
            print(json.dumps(result), flush=True)
        summary = {
            "card": card, "sites": SITES, "real_reads": int(host_counts.sum()), "iters": ITERS,
            "sms": sms, "max_sm_clock_mhz": max_hz / 1e6, "sm_clock_after_each_round": clocks,
        }
        print(json.dumps(summary), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "builds": results, "long_builds": long_results}, f, indent=1)
        bad = [r["build"] for r in results if not str(r["build"]).startswith("ablation") and (
            not r["finite"] or not r["repeat_identical"] or max(r["max_abs_err_vs_plain"].values()) > 1e-6)]
        bad += [r["build"] for r in long_results if r["build"] != "reference" and (
            not r["repeat_identical"] or not all(r["bit_identical_to_checked_in"].values())
            or max(r["max_abs_err_vs_plain"].values()) > 1e-6)]
        if bad:
            print(f"FAILED: builds off their plain version by more than 1e-6, not repeatable, or (long-site "
                  f"variants) off the checked-in bits: {bad}", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
