"""Sweep the tiling of phase A of ``ops/csrc/fused_infer.cu`` on one card.

    python -m m6anet_tpu_torch.scripts.sweep_read_tile [--widths production|tail]
        [--reference OTHER.cu] [--out FILE.json]

Phase A's fast plan is seven constants of the kernel source: reads per
thread (``kReadTile``, R), threads per block (``kReadThreads``), blocks per
SM asked of ``__launch_bounds__`` (``kReadMinBlocks``, which caps the
registers a thread may take), the unrolling of the hidden-unit loop
(``kReadUnroll``), the lanes of a group that share their reads' h1
(``kLaneGroupTile``, G), the groups' own unrolling (``kLaneGroupUnroll``)
and the most values a read keeps where lanes group (``kLaneGroupValues``:
41 takes groups at the tail's widths alone, 47 at the released widths too).
For each tiling in ``VARIANTS`` the script builds
a temporary copy of the source with those constants rewritten, and each of
``ABLATIONS``: the source as checked in with one part done another way,
whose p is wrong and whose time alone counts.  It reports for each build:

* the registers, spills and shared memory ptxas gives ``read_prob_kernel``,
  and the static count of its SASS instructions by opcode (``cuobjdump``);
* whether p is bit-identical to the source as it stands, and to
  ``--reference`` (another version of the file with the same C interface,
  such as an earlier commit's), and its largest difference from the plain
  PyTorch version;
* its time per launch of ``read_prob_launch`` (phase A alone): the median of
  CUDA-event timings over two interleaved rounds, with the L2 cache flushed
  before each launch, beside the f32 bound of 67 TFLOP/s.

``--widths production`` (the default) builds the source at its own widths
and runs the HCT116_RNA002 model on the production batch (1,048,576 reads).
``--widths tail`` builds it as the torch backend's per-read tail of the
signal-only model (9 -> 150 -> 32, no k-mer input:
``encoder_kernel.tail_defines``), with that model's weights seeded as
``chip_smoke.py`` seeds them, on the production batch's 9 features a read;
its plain version is the tail's modules.

Everything is built in a temporary directory that is removed at the end; a
build the compiler refuses is reported with the end of its log.  Prints
one JSON line per build, the card's ``nvidia-smi`` name and power limit,
and the SM clock read after each round; ``--out`` also writes them to a
file.  Needs one NVIDIA card and nvcc.
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

from ..constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS, SIGNAL_MODEL_CONFIG
from ..models import load_model
from ..models.mil import MILModel
from ..ops import _build, _native
from ..ops import encoder_kernel as enc
from ..ops import fused_infer_kernel as fik
from ._sweep import (
    READS, production_batch, sass_counts, sass_instructions, smi, time_interleaved, variant_source,
)

# (reads per thread, threads per block, blocks per SM, hidden-unit unroll,
# lanes a group, the groups' hidden-unit unroll, the most values a read
# keeps where lanes group)
VARIANTS = [
    (1, 256, 2, 2, 1, 2, 41),  # the one-read-per-thread tiling
    (2, 256, 2, 1, 1, 2, 41), (2, 256, 2, 2, 1, 2, 41), (2, 128, 4, 1, 1, 2, 41),
    (3, 128, 2, 1, 1, 2, 41), (3, 128, 2, 2, 1, 2, 41), (4, 128, 2, 2, 1, 2, 41),
    (2, 256, 2, 1, 2, 1, 41), (2, 256, 2, 1, 2, 2, 41), (2, 256, 2, 1, 2, 4, 41), (2, 128, 4, 1, 2, 2, 41),
    (2, 256, 2, 1, 4, 2, 41), (3, 128, 2, 1, 2, 2, 41), (1, 256, 2, 1, 2, 2, 41),
    (2, 256, 2, 1, 2, 1, 47), (2, 256, 2, 1, 2, 2, 47), (2, 128, 4, 1, 2, 2, 47),
]
CONSTANTS = ("kReadTile", "kReadThreads", "kReadMinBlocks", "kReadUnroll", "kLaneGroupTile", "kLaneGroupUnroll",
             "kLaneGroupValues")
# (what the build does otherwise, ((text of the source, its replacement), ...)):
# each text occurs once in the source as checked in
ABLATIONS = [
    ("half the W2 loads: a loaded float4 of W2 feeds two of a lane's float4s of outputs (wrong p)",
     (("const float4 v = fan[q];", "const float4 v = fan[q & ~1];"),)),
    ("no W2 loads: layer 2 on a constant float4 (wrong p)",
     (("const float4 v = fan[q];", "const float4 v = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);"),)),
    ("no shared loads in the unit loop: both layers on constant float4s (wrong p)",
     (("const float4 v = fan[q];", "const float4 v = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);"),
      ("const float4 v = row[q];", "const float4 v = make_float4(0.5f, -0.25f, 0.125f, -0.0625f);"))),
    ("no h1 exchange: a lane's own h1 in place of each shuffle (wrong p)",
     (("__shfl_xor_sync(kAll, h[j], d)", "h[j]"),)),
    ("W2 loaded once for two units: unrolled by 2, unit k's fan-out from row k & ~1 (wrong p)",
     (("w + kOffW2 + k * kH2Pad", "w + kOffW2 + (k & ~1) * kH2Pad"),
      ("constexpr int kUnitUnroll = kLaneGroup > 1 ? kLaneGroupUnroll : kReadUnroll;",
       "constexpr int kUnitUnroll = 2;"))),
]
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
OPCODES = ("LDS", "SHFL", "FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "SEL", "LDG", "STG")
REPS = 30  # timed launches per build and round


def ablation_source(text: str, edits) -> str:
    """``text`` with each ``(old, new)`` of ``edits`` made; each ``old``
    must occur once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"fused_infer.cu has no single {old!r} to replace")
        text = text.replace(old, new)
    return text


def target(widths: str):
    """What the builds run at ``widths`` ("production" or "tail"): the
    ``-D`` defines, the packed weights, the inputs (features, k-mer ids or
    None) on the card, p of the plain version and the FLOP a read."""
    features, kmer = (torch.from_numpy(a).cuda() for a in production_batch()[:2])
    if widths == "production":
        with open(DEFAULT_MODEL_CONFIG, "rb") as f:
            model = load_model(tomllib.load(f), PRETRAINED_CONFIGS["HCT116_RNA002"][0]).cuda()
        fp = fik.prepare_fused_params_t(model)
        w = fp.widths
        return {"defines": {}, "weights": fp.packed, "inputs": (features, kmer),
                "p_plain": fik.read_probability_plain(fp, features, kmer),
                "flop_per_read": 2 * (w.n_in * w.hidden1 + w.hidden1 * w.hidden2 + w.hidden2)}
    with open(SIGNAL_MODEL_CONFIG, "rb") as f:
        model = MILModel(tomllib.load(f)).init(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        bn = model.encoder[-2].bn
        bn.running_mean.copy_(torch.rand(bn.running_mean.shape, generator=g) - 0.5)
        bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) + 0.2)
        model = model.cuda()
        tp = enc.prepare_tail_params(model)
        x = {"X": features, "kmer": kmer}
        for blk in tp.head:
            x = blk(x)
        x = x.reshape(-1, tp.widths.n_in).contiguous()
        l1, l2 = model.encoder[-2:]
        p_plain = model.per_read_filter().per_read_prob(l2(l1(x)))
    w = tp.widths
    return {"defines": enc.tail_defines(w), "weights": tp.packed, "inputs": (x, None), "p_plain": p_plain,
            "flop_per_read": 2 * (w.n_in * w.hidden1 + w.hidden1 * w.hidden2 + w.hidden2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", choices=("production", "tail"), default="production",
                    help="the released model's widths, or the signal-only model's per-read tail")
    ap.add_argument("--reference", help="another fused_infer.cu to build and compare with")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAILED: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | widths {args.widths}",
          flush=True)
    tgt = target(args.widths)
    features, kmer = tgt["inputs"]

    tmp = tempfile.mkdtemp(prefix="sweep_read_tile_")
    try:
        source = os.path.join(_build.CSRC_DIR, "fused_infer.cu")
        with open(source) as f:
            text = f.read()
        builds = [("as checked in", source)]
        if args.reference:
            builds.insert(0, ("reference", os.path.abspath(args.reference)))
        for values in VARIANTS:
            path = os.path.join(tmp, "fused_infer_{}.cu".format("_".join(map(str, values))))
            with open(path, "w") as f:
                f.write(variant_source(text, CONSTANTS, values, "fused_infer.cu"))
            builds.append((dict(zip(CONSTANTS, values)), path))
        for n, (label, edits) in enumerate(ABLATIONS):
            path = os.path.join(tmp, f"fused_infer_ablation_{n}.cu")
            with open(path, "w") as f:
                f.write(ablation_source(text, edits))
            builds.append((f"ablation: {label}", path))
        command = [_build.nvcc_path(), *_build.NVCC_FLAGS,
                   *(f"-D{k}={v}" for k, v in sorted(tgt["defines"].items()))]
        failed = {}
        libs = _build.build_shared_libraries([(path, command) for _, path in builds], out_dir=tmp, failed=failed)

        rows, refused = [], []
        for (label, _), lib_path in zip(builds, libs):
            if lib_path in failed:
                refused.append({"build": label, "build_failed": failed[lib_path][-2000:]})
                print(json.dumps(refused[-1]), flush=True)
                continue
            lib = _native.declare(lib_path, "fused_infer")
            p = torch.empty(READS, dtype=torch.float32, device="cuda")

            def launch(lib=lib, p=p):
                err = lib.read_prob_launch(
                    features.data_ptr(), None if kmer is None else kmer.data_ptr(), tgt["weights"].data_ptr(),
                    p.data_ptr(), READS, torch.cuda.current_stream().cuda_stream,
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
                "max_abs_err_vs_plain": float((p - tgt["p_plain"]).abs().max()),
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

        bound_ms = READS * tgt["flop_per_read"] / F32_FLOPS * 1e3
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
        summary = {"card": card, "widths": args.widths, "reads": READS, "sm_clock_after_each_round": clocks}
        print(json.dumps(summary), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "builds": results + refused}, f, indent=1)
        bad = [r["build"] for r in results if not str(r["build"]).startswith("ablation")
               and (not r["finite"] or r["max_abs_err_vs_plain"] > 1e-6)]
        if bad or refused:
            print(f"FAILED: builds off their plain version by more than 1e-6: {bad}; "
                  f"builds the compiler refused: {[r['build'] for r in refused]}", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
