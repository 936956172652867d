"""Sweep ``ops/csrc/read_prob_tc.cu`` on one card: its tuning constants and
how its tensor-core sums round.

    python -m m6anet_tpu_torch.scripts.sweep_read_prob_tc [--out FILE.json]

1. For each pair in ``VARIANTS`` of the unrolling of the loop over layer 2's
   k steps (``kStepUnroll``) and the blocks per SM asked of
   ``__launch_bounds__`` (``kMinBlocks``), the script builds a temporary
   copy of the source with those constants rewritten and reports, per
   precision (f32x3, bf16): the registers and spills ptxas gives the
   kernel, whether p at a production batch (1,048,576 reads, the
   HCT116_RNA002 model's weights) is bit-identical to the source as it
   stands, and its time per launch (median of CUDA-event timings over two
   interleaved rounds, L2 flushed before each launch).
2. It holds the checked-in kernel's p against the plain version with the
   tensor-core products summed four ways: in k16 chunks whose f64 sums are
   truncated toward zero (the plain version's own model), rounded to
   nearest, or taken as f32 matmuls, and as one f32 matmul over all k.  For
   each: the largest |p - p_plain|, the reads more than 1e-6 and 1e-7
   apart, and the reads that differ at all.

Prints one JSON line per build and precision, one per way of summing, and
the card's ``nvidia-smi`` name and power limit with the SM clock read after
each round; ``--out`` also writes them to a file.  Needs one NVIDIA card and
nvcc.
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
from unittest import mock

import numpy as np
import torch

from ..constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
from ..models import load_model
from ..ops import _build
from ..ops import fused_infer_kernel as fik
from ._sweep import smi, time_interleaved, variant_source

# (k-step unroll, blocks per SM)
VARIANTS = [(1, 2), (2, 2), (10, 2), (1, 3), (1, 1), (2, 1)]
CONSTANTS = ("kStepUnroll", "kMinBlocks")
MODES = ("f32x3", "bf16")
READS = 1 << 20  # the production batch
REPS = 20  # timed launches per build, precision and round


def _chunks(a: torch.Tensor, b: torch.Tensor, chunk_sum) -> torch.Tensor:
    out = None
    for k in range(0, a.shape[1], 16):
        part = chunk_sum(a[:, k : k + 16], b[:, k : k + 16])
        out = part if out is None else out + part
    return out


# how the plain version sums the products the kernel takes on the tensor cores
SUMS = {
    "k16 chunks, f64 sums truncated toward zero (the plain version)": fik._tensor_core_matmul,
    "k16 chunks, f64 sums rounded to nearest": lambda a, b: _chunks(
        a, b, lambda x, y: torch.matmul(x.double(), y.double().t()).float()),
    "k16 chunks, f32 matmuls": lambda a, b: _chunks(a, b, lambda x, y: torch.matmul(x, y.t())),
    "one f32 matmul": lambda a, b: torch.matmul(a, b.t()),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    rng = np.random.default_rng(0)
    features = torch.from_numpy(rng.normal(size=(READS, 9)).astype(np.float32)).cuda()
    kmer = torch.from_numpy(rng.integers(0, 66, size=(READS, 3)).astype(np.int8)).cuda()

    results = []
    for mode in MODES:
        p = torch.empty(READS, dtype=torch.float32, device="cuda")
        fik.launch_read_prob_tc(fp, features, kmer, p, mode)  # the checked-in kernel
        for name, tensor_core_sum in SUMS.items():
            with mock.patch.object(fik, "_tensor_core_matmul", tensor_core_sum):
                err = (p - fik.read_probability_plain(fp, features, kmer, mode)).abs()
            result = {
                "precision": mode, "plain_sums": name, "max_abs_err": float(err.max()),
                "reads_above_1e-6": int((err > 1e-6).sum()), "reads_above_1e-7": int((err > 1e-7).sum()),
                "reads_differing": int((err > 0).sum()),
            }
            results.append(result)
            print(json.dumps(result), flush=True)

    tmp = tempfile.mkdtemp(prefix="sweep_read_prob_tc_")
    try:
        source = os.path.join(_build.CSRC_DIR, "read_prob_tc.cu")
        with open(source) as f:
            text = f.read()
        builds = [("as checked in", source)]
        for values in VARIANTS:
            path = os.path.join(tmp, "read_prob_tc_u{}_b{}.cu".format(*values))
            with open(path, "w") as f:
                f.write(variant_source(text, CONSTANTS, values, "read_prob_tc.cu"))
            builds.append((dict(zip(CONSTANTS, values)), path))
        command = [_build.nvcc_path(), *_build.NVCC_FLAGS]
        libs = _build.build_shared_libraries([(path, command) for _, path in builds], out_dir=tmp)

        rows = []
        for (label, _), lib_path in zip(builds, libs):
            lib = ctypes.CDLL(lib_path)
            lib.read_prob_tc_launch.restype = ctypes.c_int
            lib.read_prob_tc_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            for mode in MODES:
                p = torch.empty(READS, dtype=torch.float32, device="cuda")

                def launch(lib=lib, p=p, code=fik.TC_MODES[mode]):
                    err = lib.read_prob_tc_launch(
                        features.data_ptr(), kmer.data_ptr(), fp.tc.data_ptr(), p.data_ptr(),
                        READS, code, torch.cuda.current_stream().cuda_stream,
                    )
                    if err != 0:
                        raise RuntimeError(f"read_prob_tc_launch failed with CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                rows.append({
                    "build": label, "precision": mode, "launch": launch, "p": p,
                    "ptxas": _build.ptxas_usage(lib_path, f"read_prob_tc_kernelILi{fik.TC_MODES[mode]}E"),
                })
        checked_in = {r["precision"]: r["p"] for r in rows if r["build"] == "as checked in"}
        times, clocks = time_interleaved([row["launch"] for row in rows], REPS)
        for row, row_times in zip(rows, times):
            half = len(row_times) // 2
            result = {
                "build": row["build"], "precision": row["precision"], "ptxas": row["ptxas"],
                "ms": statistics.median(row_times),
                "ms_by_round": [statistics.median(row_times[:half]), statistics.median(row_times[half:])],
                "bit_identical_to_checked_in": torch.equal(row["p"], checked_in[row["precision"]]),
            }
            results.append(result)
            print(json.dumps(result), flush=True)
        summary = {"card": card, "reads": READS, "sm_clock_after_each_round": clocks}
        print(json.dumps(summary), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "results": results}, f, indent=1)
        bad = [(r["build"], r["precision"]) for r in results if r.get("bit_identical_to_checked_in") is False]
        if bad:
            print(f"FAILED: builds whose p differs from the checked-in build's: {bad}", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
