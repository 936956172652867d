"""Sweep phase B of ``ops/csrc/fused_infer.cu`` (``site_reduce_kernel``) on
one card.

    python -m m6anet_tpu_torch.scripts.sweep_site_reduce [--reference DIR] [--out FILE.json]

Phase B's shape is three constants of its source: threads a block
(``kSiteThreads``), lanes a site's reads are spread over (``kSiteLanes``)
and 16-byte loads a lane issues at once (``kChunkLoads``).
For each set in ``VARIANTS`` the script builds a temporary copy of the
source with those lines rewritten, and the ``ABLATIONS``: the source as
checked in with one part done another way or left out.  With
``--reference DIR`` (a directory
holding another version's ``fused_infer.cu`` and ``read_prob_tc.cu`` with
the same C interface and weight images, such as ``ops/csrc`` of a ``git
archive`` of an earlier commit) it builds those too.  For each build it
reports:

* the registers and spills ptxas gives ``site_reduce_kernel``;
* whether its site_p and mod_ratio are the same bits (NaN as NaN) as the
  reference's, the checked-in build's and the plain version's
  (``fused_infer_kernel.site_reduce_plain``), on the p of each precision's
  phase A (f32, f32x3, bf16) at the production batch
  (``_sweep.production_batch``) and on ``fused_infer_kernel.site_reduce_batch``
  (counts 0, 1, 20-1,000 and 57,344, p at the edges of the exact sums, NaN
  reads);
* whether p of its f32 phase A is the same bits as the checked-in build's
  and, in every precision, p of the checked-in kernels as the reference's;
* its times (medians of CUDA-event timings over two interleaved rounds, L2
  flushed before each launch, at the production batch): phase B alone on
  the f32x3 p, and the pair (phase A then phase B) in each precision: f32
  is the build's own ``fused_infer_launch``, f32x3 and bf16 the checked-in
  ``read_prob_tc.cu`` then the build's phase B (the reference's pair is its
  own two kernels), beside phase B's bound (its bytes over 3.35 TB/s).

Everything is built in a temporary directory that is removed at the end.
Prints ``[launching] <build>`` to stderr before each build's first launch,
one JSON line per build, the card's ``nvidia-smi`` name and power limit and
the SM clock read after each round; ``--out`` also writes them to a file.
Fails when a build that is not an ablation differs from the plain version
or the reference.  Needs one NVIDIA card and nvcc.
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
from ..ops import _build, _native
from ..ops import fused_infer_kernel as fik
from ._sweep import production_batch, same_bits, smi, time_interleaved, variant_source

# (threads a block, lanes a site, loads a lane issues at once)
VARIANTS = [
    (256, 32, 2),  # one site a warp, with the exact sums
    (256, 32, 4), (256, 16, 2), (256, 16, 4), (256, 16, 8), (256, 8, 4), (256, 8, 8), (256, 4, 8),
    (512, 16, 4), (512, 8, 8), (128, 16, 4),
]
CONSTANTS = ("kSiteThreads", "kSiteLanes", "kChunkLoads")
# builds that do a part of the work another way or leave it out, timed
# beside the others; their outputs are reported, not held to the others'
ABLATIONS = [
    ("the f64 shuffle tree in place of redux.sync", "return __reduce_add_sync(group, v);",
     "double d = v; for (int o = kSiteLanes / 2; o > 0; o >>= 1) d += __shfl_xor_sync(group, d, o); "
     "return static_cast<uint32_t>(d);"),
    ("without the loads of p (wrong sums)", "reinterpret_cast<const float4*>(a)[q]",
     "make_float4(0.5f, 0.5f, 0.5f, 0.5f)"),
    ("the launch alone: the kernel returns at once", "  constexpr int G = kSiteLanes;\n",
     "  if (n_sites >= 0) return;\n  constexpr int G = kSiteLanes;\n"),
]
MODES = ("f32", "f32x3", "bf16")
REPS = 30  # timed launches per launch kind and round
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)


def bind(lib_path: str, tc: bool = False) -> ctypes.CDLL:
    """A build of fused_infer.cu (or, with ``tc``, of read_prob_tc.cu) with
    its launches' C interfaces declared."""
    return _native.declare(lib_path, "read_prob_tc" if tc else "fused_infer")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", help="a directory with another fused_infer.cu and read_prob_tc.cu")
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
    threshold = PRETRAINED_CONFIGS["HCT116_RNA002"][1]
    fp = fik.prepare_fused_params_t(model)
    batch = production_batch()
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    n_reads, n_sites = features.shape[0], counts.shape[0]
    # p of the checked-in phase A in each precision, and phase B's cases
    p_mode = {m: fik.fused_inference_t(fp, features, kmer, None, offsets, counts, threshold, 20, m)[0]
              for m in MODES}
    cases = {f"production {m}": (p_mode[m], offsets, counts) for m in MODES}
    cases["site_reduce_batch"] = tuple(torch.from_numpy(a).cuda() for a in fik.site_reduce_batch())
    plain = {name: fik.site_reduce_plain(*case, threshold) for name, case in cases.items()}
    # the reads of the spans once, offsets and counts in, site_p and mod_ratio out
    phase_b_bytes = 4 * int(batch[3].sum()) + 16 * n_sites

    tmp = tempfile.mkdtemp(prefix="sweep_site_reduce_")
    try:
        source = os.path.join(_build.CSRC_DIR, "fused_infer.cu")
        with open(source) as f:
            text = f.read()
        builds = [("as checked in", source)]
        if args.reference:
            builds.insert(0, ("reference", os.path.join(os.path.abspath(args.reference), "fused_infer.cu")))
        for values in VARIANTS:
            path = os.path.join(tmp, "fused_infer_t{}_s{}_c{}.cu".format(*values))
            with open(path, "w") as f:
                f.write(variant_source(text, CONSTANTS, values, "fused_infer.cu"))
            builds.append((dict(zip(CONSTANTS, values)), path))
        for n, (label, old, new) in enumerate(ABLATIONS):
            if text.count(old) != 1:
                raise SystemExit(f"fused_infer.cu has no single {old!r} to replace")
            path = os.path.join(tmp, f"fused_infer_ablation_{n}.cu")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            builds.append((f"ablation: {label}", path))
        tc_sources = [os.path.join(_build.CSRC_DIR, "read_prob_tc.cu")]
        if args.reference:
            tc_sources.append(os.path.join(os.path.abspath(args.reference), "read_prob_tc.cu"))
        command = [_build.nvcc_path(), *_build.NVCC_FLAGS]
        libs = _build.build_shared_libraries(
            [(path, command) for _, path in builds] + [(path, command) for path in tc_sources], out_dir=tmp)
        tc_libs = [bind(path, tc=True) for path in libs[len(builds):]]

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def tc_launch(tc_lib, mode, p):
            check(tc_lib.read_prob_tc_launch(features.data_ptr(), kmer.data_ptr(), fp.tc.data_ptr(), p.data_ptr(),
                                             n_reads, fik.TC_MODES[mode], stream()), "read_prob_tc_launch")

        p_reference = None
        if args.reference:  # p of the reference's phase A in each precision
            ref = bind(libs[0])
            p_reference = {}
            for mode in MODES:
                p = torch.empty(n_reads, dtype=torch.float32, device="cuda")
                if mode == "f32":
                    out = torch.empty(n_sites, dtype=torch.float32, device="cuda")
                    check(ref.fused_infer_launch(
                        features.data_ptr(), kmer.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
                        fp.packed.data_ptr(), p.data_ptr(), out.data_ptr(), out.data_ptr(), n_reads, n_sites,
                        threshold, 20, stream()), "fused_infer_launch")
                else:
                    tc_launch(tc_libs[1], mode, p)
                p_reference[mode] = p
            torch.cuda.synchronize()

        rows = []
        for (label, _), lib_path in zip(builds, libs[: len(builds)]):
            print(f"[launching] {label}", file=sys.stderr, flush=True)
            lib = bind(lib_path)
            tc_lib = tc_libs[1] if label == "reference" else tc_libs[0]
            site_p = torch.empty(n_sites, dtype=torch.float32, device="cuda")
            mod_ratio = torch.empty(n_sites, dtype=torch.float32, device="cuda")
            p_pair = torch.empty(n_reads, dtype=torch.float32, device="cuda")

            def phase_b(p, o, c, sp, mr, lib=lib):
                check(lib.site_reduce_launch(p.data_ptr(), o.data_ptr(), c.data_ptr(), sp.data_ptr(), mr.data_ptr(),
                                             p.shape[0], c.shape[0], threshold, 20, stream()), "site_reduce_launch")

            def pair(mode, lib=lib, tc_lib=tc_lib, phase_b=phase_b, sp=site_p, mr=mod_ratio, p=p_pair):
                if mode == "f32":
                    check(lib.fused_infer_launch(
                        features.data_ptr(), kmer.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
                        fp.packed.data_ptr(), p.data_ptr(), sp.data_ptr(), mr.data_ptr(), n_reads, n_sites,
                        threshold, 20, stream()), "fused_infer_launch")
                else:
                    tc_launch(tc_lib, mode, p)
                    phase_b(p, offsets, counts, sp, mr)

            outputs = {}
            for name, (p, o, c) in cases.items():
                sp = torch.empty(c.shape[0], dtype=torch.float32, device="cuda")
                mr = torch.empty_like(sp)
                phase_b(p, o, c, sp, mr)
                sp2, mr2 = torch.empty_like(sp), torch.empty_like(sp)
                phase_b(p, o, c, sp2, mr2)
                torch.cuda.synchronize()
                outputs[name] = (sp, mr, same_bits(sp, sp2) and same_bits(mr, mr2))
            pair("f32")
            torch.cuda.synchronize()
            f32_pair = (p_pair.clone(), site_p.clone(), mod_ratio.clone())
            rows.append({
                "build": label,
                "launches": [lambda b=phase_b, p=p_mode["f32x3"], sp=site_p, mr=mod_ratio: b(p, offsets, counts, sp, mr)]
                + [lambda m=m, pair=pair: pair(m) for m in MODES],
                "ptxas": _build.ptxas_usage(lib_path, "site_reduce_kernel"),
                "outputs": outputs, "f32_pair": f32_pair,
            })

        checked_in = next(r for r in rows if r["build"] == "as checked in")
        reference = rows[0] if args.reference else None
        results = []
        times, clocks = time_interleaved([launch for row in rows for launch in row["launches"]], REPS)
        kinds = ["phase_b_alone_f32x3_p"] + [f"pair_{m}" for m in MODES]
        bound_ms = phase_b_bytes / PEAK_BYTES_PER_S * 1e3
        for k, row in enumerate(rows):
            row_times = times[k * len(kinds) : (k + 1) * len(kinds)]
            result = {"build": row["build"], "ptxas": row["ptxas"], "phase_b_bound_ms": bound_ms}
            for kind, ts in zip(kinds, row_times):
                half = len(ts) // 2
                result[f"{kind}_ms"] = statistics.median(ts)
                result[f"{kind}_ms_by_round"] = [statistics.median(ts[:half]), statistics.median(ts[half:])]
            result["phase_b_bound_share"] = bound_ms / result["phase_b_alone_f32x3_p_ms"]
            out = row["outputs"]
            result["repeat_identical"] = all(v[2] for v in out.values())
            result["same_as_plain"] = {n: same_bits(v[0], plain[n][0]) and same_bits(v[1], plain[n][1]) for n, v in out.items()}
            result["same_as_checked_in"] = {
                n: same_bits(v[0], checked_in["outputs"][n][0]) and same_bits(v[1], checked_in["outputs"][n][1])
                for n, v in out.items()}
            result["f32_pair_same_as_checked_in"] = all(
                same_bits(a, b) for a, b in zip(row["f32_pair"], checked_in["f32_pair"]))
            if reference is not None:
                result["same_as_reference"] = {
                    n: same_bits(v[0], reference["outputs"][n][0]) and same_bits(v[1], reference["outputs"][n][1])
                    for n, v in out.items()}
            results.append(result)
            print(json.dumps(result), flush=True)
        summary = {"card": card, "reads": n_reads, "sites": n_sites, "real_reads": int(batch[3].sum()),
                   "phase_b_bytes": phase_b_bytes, "sm_clock_after_each_round": clocks}
        if p_reference is not None:
            summary["p_same_as_reference"] = {m: same_bits(p_mode[m], p_reference[m]) for m in MODES}
        print(json.dumps(summary), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "builds": results}, f, indent=1)
        bad = [r["build"] for r in results if not str(r["build"]).startswith("ablation") and r["build"] != "reference"
               and not (r["repeat_identical"] and all(r["same_as_plain"].values())
                        and r["f32_pair_same_as_checked_in"]
                        and all(r.get("same_as_reference", {"": True}).values()))]
        if p_reference is not None and not all(summary["p_same_as_reference"].values()):
            bad.append("p of the checked-in phase A")
        if bad:
            print(f"FAILED: not the same bits as the plain version, the reference or the checked-in p: {bad}",
                  file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
