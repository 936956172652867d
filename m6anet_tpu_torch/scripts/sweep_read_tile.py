"""Sweep the tiling of phase A of ``ops/csrc/fused_infer.cu`` on one card.

    python -m m6anet_tpu_torch.scripts.sweep_read_tile [--reference OTHER.cu] [--out FILE.json]

Phase A's tiling is four constants of the kernel source: reads per thread
(``kReadTile``, R), threads per block (``kReadThreads``), blocks per SM asked
of ``__launch_bounds__`` (``kReadMinBlocks``, which caps the registers a
thread may take) and the unrolling of the hidden-unit loop
(``kReadUnroll``).  For each tiling in ``VARIANTS`` the script builds a
temporary copy of the source with those constants rewritten, and reports:

* the registers, spills and shared memory ptxas gives ``read_prob_kernel``,
  and the static count of its SASS instructions by opcode (``cuobjdump``);
* whether p at a production batch (1,048,576 reads, the HCT116_RNA002
  model's weights) is bit-identical to the source as it stands, and to
  ``--reference`` (another version of the file with the same C interface,
  such as an earlier commit's), and its largest difference from the plain
  PyTorch version;
* its time per launch of ``read_prob_launch`` (phase A alone): the median of
  CUDA-event timings over two interleaved rounds, with the L2 cache flushed
  before each launch, beside the f32 bound of 67 TFLOP/s.

Everything is built in a temporary directory that is removed at the end.
Prints one JSON line per build, the card's ``nvidia-smi`` name and power
limit, and the SM clock read after each round; ``--out`` also writes them to
a file.  Needs one NVIDIA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
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
from ..ops import _build
from ..ops import fused_infer_kernel as fik
from ._sweep import (
    READS, production_batch, sass_counts, sass_instructions, smi, time_interleaved, variant_source,
)

# (reads per thread, threads per block, blocks per SM, hidden-unit unroll)
VARIANTS = [
    (1, 256, 2, 2),  # the one-read-per-thread tiling
    (2, 256, 2, 1), (2, 256, 2, 2), (2, 128, 3, 1), (2, 128, 4, 1), (2, 64, 8, 1),
    (3, 128, 2, 1), (3, 128, 2, 2), (3, 160, 2, 1), (3, 160, 2, 2),
    (4, 128, 2, 1), (4, 128, 2, 2),
]
CONSTANTS = ("kReadTile", "kReadThreads", "kReadMinBlocks", "kReadUnroll")
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
FLOP_PER_READ = 2 * (15 * 150 + 150 * 32 + 32)
OPCODES = ("LDS", "FFMA", "FMUL", "FADD", "FMNMX", "LDG", "STG")
REPS = 30  # timed launches per build and round


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", help="another fused_infer.cu to build and compare with")
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
    features, kmer = (torch.from_numpy(a).cuda() for a in production_batch()[:2])
    p_plain = fik.read_probability_plain(fp, features, kmer)

    tmp = tempfile.mkdtemp(prefix="sweep_read_tile_")
    try:
        source = os.path.join(_build.CSRC_DIR, "fused_infer.cu")
        with open(source) as f:
            text = f.read()
        builds = [("as checked in", source)]
        if args.reference:
            builds.insert(0, ("reference", os.path.abspath(args.reference)))
        for values in VARIANTS:
            path = os.path.join(tmp, "fused_infer_r{}_t{}_b{}_u{}.cu".format(*values))
            with open(path, "w") as f:
                f.write(variant_source(text, CONSTANTS, values, "fused_infer.cu"))
            builds.append((dict(zip(CONSTANTS, values)), path))
        command = [_build.nvcc_path(), *_build.NVCC_FLAGS]
        libs = _build.build_shared_libraries([(path, command) for _, path in builds], out_dir=tmp)

        rows = []
        for (label, _), lib_path in zip(builds, libs):
            lib = ctypes.CDLL(lib_path)
            lib.read_prob_launch.restype = ctypes.c_int
            lib.read_prob_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
            p = torch.empty(READS, dtype=torch.float32, device="cuda")

            def launch(lib=lib, p=p):
                err = lib.read_prob_launch(
                    features.data_ptr(), kmer.data_ptr(), fp.packed.data_ptr(), p.data_ptr(),
                    READS, torch.cuda.current_stream().cuda_stream,
                )
                if err != 0:
                    raise RuntimeError(f"read_prob_launch failed with CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            rows.append({
                "build": label, "launch": launch,
                "ptxas": _build.ptxas_usage(lib_path, "read_prob_kernel"),
                "sass": sass_counts(sass_instructions(lib_path, "read_prob_kernel"), OPCODES, (".128",)),
                "p": p.clone(),
                "max_abs_err_vs_plain": float((p - p_plain).abs().max()),
                "finite": bool(torch.isfinite(p).all()),
            })
        checked_in = next(r["p"] for r in rows if r["build"] == "as checked in")
        reference = rows[0]["p"] if args.reference else None
        for row in rows:
            row["bit_identical_to_checked_in"] = torch.equal(row["p"], checked_in)
            if reference is not None:
                row["bit_identical_to_reference"] = torch.equal(row["p"], reference)

        times, clocks = time_interleaved([row["launch"] for row in rows], REPS)
        for row, row_times in zip(rows, times):
            row["times"] = row_times

        bound_ms = READS * FLOP_PER_READ / F32_FLOPS * 1e3
        results = []
        for row in rows:
            half = len(row["times"]) // 2
            ms = statistics.median(row["times"])
            result = {
                "build": row["build"], "ptxas": row["ptxas"], "sass_static_counts": row["sass"],
                "ms": ms, "ms_by_round": [statistics.median(row["times"][:half]),
                                          statistics.median(row["times"][half:])],
                "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                "max_abs_err_vs_plain": row["max_abs_err_vs_plain"], "finite": row["finite"],
                "bit_identical_to_checked_in": row["bit_identical_to_checked_in"],
            }
            if reference is not None:
                result["bit_identical_to_reference"] = row["bit_identical_to_reference"]
            results.append(result)
            print(json.dumps(result), flush=True)
        summary = {"card": card, "reads": READS, "sm_clock_after_each_round": clocks}
        print(json.dumps(summary), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "builds": results}, f, indent=1)
        bad = [r["build"] for r in results if not r["finite"] or r["max_abs_err_vs_plain"] > 1e-6]
        if bad:
            print(f"FAILED: builds off their plain version by more than 1e-6: {bad}", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
