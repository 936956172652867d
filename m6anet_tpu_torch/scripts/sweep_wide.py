"""Sweep the tunings of phase A's wide plans on one card.

    python -m m6anet_tpu_torch.scripts.sweep_wide [--out FILE.json]

Past the widths of their fast plans, ``ops/csrc/fused_infer.cu`` (f32)
and ``ops/csrc/read_prob_tc.cu`` (f32x3, bf16) run phase A on their wide
plans, ``read_prob_wide_kernel`` and ``read_prob_tc_wide_kernel``: a block
takes a tile of reads and walks H1 in steps whose weights it stages in
shared memory once.  Their tunings are constants of the sources: in f32
``kWideReads`` (reads a tile), ``kWideChunk`` (hidden units a step),
``kWideTileReads`` (reads of a thread's layer-1 micro-tile) and
``kWideStages`` (weight buffers in flight); in the tensor-core modes
``kTcWideWarps`` (warps a block, 16 reads each), ``kF32x3WideChunk`` and
``kBf16WideChunk`` (hidden units a step), ``kTcWideStages`` and
``kWidePassCap`` (n8 tiles of layer 2 a pass).  At
each widths of ``WIDTHS`` where a mode's phase A is wide, the script
builds the source as it stands and a temporary copy for each tuning of
``F32_VARIANTS`` / ``TC_VARIANTS`` (the constants' lines rewritten; the
widths as ``-D`` defines, int16 k-mer ids past 128 k-mers), and reports
for each build:

* whether it builds (a tuning whose block passes the shared memory fails
  the source's static_assert) and the registers and spills ptxas gives the
  wide kernel;
* whether p at 1,048,576 seeded reads (the production batch's size, ids
  over the whole vocabulary, a seeded model) is bit-identical to the
  source as it stands (no tuning changes a read's operations, so every
  build must be), and its largest difference from the plain version;
* its time per launch of phase A alone: the median of CUDA-event timings
  over two interleaved rounds, the L2 cache flushed before each launch,
  beside the mode's bound (its operations on their pipes: f32 2 (n_in H1 +
  H1 H2 + H2) FLOP a read at 67 TFLOP/s; f32x3 layer 1 there and its three
  bf16 products at 989 TFLOP/s; bf16 all at 989).

Everything is built in a temporary directory that is removed at the end.
Prints one JSON line per build and the card's ``nvidia-smi`` name and
power limit; ``--out`` also writes them to a file.  Fails where a build
that builds changes p.  Needs one NVIDIA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import sys
import tempfile

import numpy as np
import torch

from ..models.mil import MILModel
from ..ops import _build, _native
from ..ops import fused_infer_kernel as fik
from ._sweep import READS, same_bits, smi, time_interleaved

# chip_smoke.py phase 23's widths (positions, embedding, H1, H2, vocabulary)
WIDTHS = {"W8": (3, 2, 512, 32), "W9": (3, 2, 150, 128), "W10": (11, 8, 256, 64),
          "W12": (11, 8, 512, 128, 1024)}
F32_VARIANTS = [{"kWideChunk": 32, "kWideTileReads": 4}, {"kWideTileReads": 4}, {"kWideStages": 3}]
TC_VARIANTS = [{"kTcWideStages": 2}, {"kTcWideWarps": 4}, {"kF32x3WideChunk": 64}, {"kBf16WideChunk": 32},
               {"kBf16WideChunk": 128}, {"kWidePassCap": 8}]
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense (data sheet)
REPS = 5  # timed launches per build and round


def bound_ms(w: fik.Widths, mode: str) -> float:
    """The least time phase A of ``mode`` could take at ``w`` over READS
    reads, from its operations on their pipes (all widths swept are far
    above the bytes' bound)."""
    layer1, rest = 2 * w.n_in * w.hidden1, 2 * (w.hidden1 * w.hidden2 + w.hidden2)
    seconds = {"f32": (layer1 + rest) / F32_FLOPS, "f32x3": max(layer1 / F32_FLOPS, 3 * rest / BF16_FLOPS),
               "bf16": (layer1 + rest) / BF16_FLOPS}[mode]
    return seconds * READS * 1e3


def id_bytes(w: fik.Widths) -> int:
    """Bytes of the k-mer ids the sweep's reads take: over the whole
    vocabulary, int16 past 128 k-mers."""
    return np.dtype(fik.kmer_dtype(w.vocab)).itemsize


def set_constants(text: str, values: dict, source_name: str) -> str:
    """``text`` with each ``constexpr int <name> = ...;`` line set to its
    value."""
    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{source_name} has no single line 'constexpr int {name} = ...;'")
    return text


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

    # the libraries as they stand, all at once (phase_a_wide asks them)
    _build.build_cuda(variants=[(source, fik.kernel_defines(fik.Widths(*w), id_bytes(fik.Widths(*w))))
                                for w in WIDTHS.values() for source in ("fused_infer", "read_prob_tc")])
    tmp = tempfile.mkdtemp(prefix="sweep_wide_")
    try:
        builds = []  # (widths name, source, mode(s), tuning, path, defines)
        for name, widths in WIDTHS.items():
            w = fik.Widths(*widths)
            defines = fik.kernel_defines(w, id_bytes(w))
            for source, modes, variants in (("fused_infer", ["f32"], F32_VARIANTS),
                                            ("read_prob_tc", ["f32x3", "bf16"], TC_VARIANTS)):
                modes = [m for m in modes if fik.phase_a_wide(m, w, id_bytes(w))]
                if not modes:
                    continue
                path = os.path.join(_build.CSRC_DIR, f"{source}.cu")
                builds.append((name, source, modes, "as checked in", path, defines))
                with open(path) as f:
                    text = f.read()
                for values in variants:
                    variant = os.path.join(tmp, f"{source}_{name}_{'_'.join(f'{k}{v}' for k, v in values.items())}.cu")
                    with open(variant, "w") as f:
                        f.write(set_constants(text, values, f"{source}.cu"))
                    builds.append((name, source, modes, values, variant, defines))
        base = [_build.nvcc_path(), *_build.NVCC_FLAGS]
        failed = {}
        libs = _build.build_shared_libraries(
            [(path, base + [f"-D{k}={v}" for k, v in sorted(defines.items())]) for *_, path, defines in builds],
            out_dir=tmp, failed=failed)
        results = []
        for (name, source, modes, tuning, _, _), lib in zip(builds, libs):
            if lib in failed:
                if tuning == "as checked in":
                    raise SystemExit(f"{source}.cu as checked in does not build at {name}:\n{failed[lib]}")
                error = next((ln.strip() for ln in failed[lib].splitlines() if "error" in ln), "")
                result = {"widths": name, "modes": modes, "source": source, "build": tuning, "builds": False,
                          "error": error}
                results.append(result)
                print(json.dumps(result), flush=True)

        for name, widths in WIDTHS.items():
            w = fik.Widths(*widths)
            model = MILModel(fik.widths_config(w)).init(torch.Generator().manual_seed(0)).eval().cuda()
            fp = fik.prepare_fused_params_t(model)
            rng = np.random.default_rng(7)
            features = torch.from_numpy(rng.standard_normal(size=(READS, w.features), dtype=np.float32)).cuda()
            kmer = torch.from_numpy(
                rng.integers(0, w.vocab, size=(READS, w.positions)).astype(fik.kmer_dtype(w.vocab))).cuda()
            stream = torch.cuda.current_stream().cuda_stream
            for mode in ("f32", "f32x3", "bf16"):
                rows = [(b, lib) for b, lib in zip(builds, libs) if b[0] == name and mode in b[2] and lib not in failed]
                if not rows:
                    continue
                p_plain = fik.read_probability_plain(fp, features, kmer, mode)
                launches, outs, usage = [], [], []
                for (_, source, _, _, _, _), lib_path in rows:
                    lib = _native.declare(lib_path, source)
                    p = torch.empty(READS, dtype=torch.float32, device="cuda")
                    if source == "fused_infer":
                        def launch(lib=lib, p=p):
                            return lib.read_prob_launch(features.data_ptr(), kmer.data_ptr(), fp.packed.data_ptr(),
                                                        p.data_ptr(), READS, stream)
                        kernel = "read_prob_wide_kernel"
                    else:
                        def launch(lib=lib, p=p):
                            return lib.read_prob_tc_launch(features.data_ptr(), kmer.data_ptr(), fp.tc.data_ptr(),
                                                           p.data_ptr(), READS, fik.TC_MODES[mode], stream)
                        kernel = f"read_prob_tc_wide_kernelILi{fik.TC_MODES[mode]}E"
                    if launch() != 0:
                        raise RuntimeError(f"{source} at {name} did not launch")
                    torch.cuda.synchronize()
                    launches.append(launch)
                    outs.append(p)
                    usage.append(_build.ptxas_usage(lib_path, kernel))
                times, clocks = time_interleaved(launches, REPS)
                for ((_, source, _, tuning, _, _), _), row_times, p, ptxas in zip(rows, times, outs, usage):
                    ms = statistics.median(row_times)
                    result = {"widths": name, "mode": mode, "source": source, "build": tuning, "builds": True,
                              "ptxas": ptxas, "ms": ms, "bound_ms": bound_ms(w, mode),
                              "bound_share": bound_ms(w, mode) / ms,
                              "bit_identical_to_checked_in": same_bits(p, outs[0]),
                              "max_abs_err_vs_plain": float((p - p_plain).abs().max()),
                              "sm_clock_after_each_round": clocks}
                    results.append(result)
                    print(json.dumps(result), flush=True)
        summary = {"card": card, "reads": READS}
        print(json.dumps(summary), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "builds": results}, f, indent=1)
        bad = [(r["widths"], r["mode"], r["build"]) for r in results
               if r["builds"] and not r["bit_identical_to_checked_in"]]
        if bad:
            print(f"FAILED: builds that change p: {bad}", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
