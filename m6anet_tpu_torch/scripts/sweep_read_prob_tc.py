"""Sweep ``ops/csrc/read_prob_tc.cu`` on one card: its tuning constants, how
its tensor-core sums round, and where an older version's time goes.

    python -m m6anet_tpu_torch.scripts.sweep_read_prob_tc [--reference OTHER] [--out FILE.json]

1. It holds the checked-in kernel's p against the plain version with the
   tensor-core products summed four ways: in k16 chunks whose f64 sums are
   truncated toward zero (the plain version's own model), rounded to
   nearest, or taken as f32 matmuls, and as one f32 matmul over all k.  For
   each: the largest |p - p_plain|, the reads more than 1e-6 and 1e-7
   apart, and the reads that differ at all.
2. It builds the source as it stands and, for each tuple in ``VARIANTS``
   of consumer warpgroups per block, stages of the input ring, 64-read
   tiles an item (a lane holds two reads of each) and the registers a
   thread of the producer warpgroup keeps (setmaxnreg gives the rest to the
   consumers), a temporary copy with those constants rewritten in both
   modes (``variant_constants``).  With ``--reference`` it builds another
   version too: either a read_prob_tc.cu with the same C interface and
   weight image, or the root of an earlier copy of this package (``git
   archive`` of a commit's ``m6anet_tpu_torch``), whose kernel is fed the
   image its own ``prepare_fused_params_t`` packs.  Of each source that
   has the code they patch (the checked-in one, the reference), it also
   builds the ``ABLATIONS``: copies with one part of the work taken out, to
   attribute its time.
3. For each build and precision (f32x3, bf16) it reports the registers,
   spills and static shared memory ptxas gives the kernel, whether ptxas
   serialised its ``wgmma``, the kernel's own launch configuration where
   the build reports it, its time per launch (median of CUDA-event timings
   over two interleaved rounds, L2 flushed before each launch) at a
   production batch (1,048,576 reads, the HCT116_RNA002 model's weights),
   and whether p is bit-identical to the checked-in build and to the
   reference, there and on ``ragged_tail_batches`` of both modes'
   checked-in tiles (with the number of reads that differ and the largest
   difference).

Prints one JSON line per build and precision, one per way of summing, and
the card's ``nvidia-smi`` name and power limit with the SM clock read after
each round; ``--out`` also writes them to a file.  Fails when a build that
is not an ablation differs from the checked-in one.  Needs one NVIDIA card
and nvcc.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import os
import shutil
import statistics
import sys
import tempfile
import tomllib
from unittest import mock

import torch

from ..constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
from ..models import load_model
from ..ops import _build, _native
from ..ops import fused_infer_kernel as fik
from ._sweep import READS, production_batch, smi, time_interleaved, variant_source

# (consumer warpgroups, ring stages, 64-read tiles an item, registers
# setmaxnreg leaves the producer warpgroup), set in both modes; the stages
# are a multiple of the consumer warpgroups, as the kernel requires
VARIANTS = [
    (2, 4, 1, 24), (3, 3, 1, 24), (3, 6, 1, 24),
    (2, 2, 2, 24), (2, 4, 2, 24), (2, 6, 2, 24), (3, 6, 2, 24),
]
VARIANT_KEYS = ("consumers", "stages", "tiles", "producer_regs")
MODES = ("f32x3", "bf16")
REPS = 20  # timed launches per build, precision and round


def variant_constants(values):
    """The read_prob_tc.cu constants a ``VARIANTS`` tuple sets, and their
    values: the consumers, stages and tiles of both modes, and the
    producer's registers."""
    consumers, stages, tiles, producer_regs = values
    names = [f"k{mode}{name}" for mode in ("F32x3", "Bf16") for name in ("Consumers", "Stages", "Tiles")]
    return names + ["kProducerRegs"], [consumers, stages, tiles] * 2 + [producer_regs]


# Ablations as exact replacements in a source's text, by the version they
# patch: each build leaves out one part of the work and keeps the rest, so
# its time against the whole kernel's is what that part costs.  A source
# without a set's lines gets none of its builds.
_MMA_SYNC_ABLATIONS = {  # a warp per 16 reads on mma.sync
    # (a) every read's inputs from a shared-memory row (the embedding table
    # at an offset that moves with the read), no device-memory load
    "a: inputs from shared memory": [
        ("""  const float* f = features + r * kFeat;
#pragma unroll
  for (int i = 0; i < kFeat; ++i) x[i] = __ldg(f + i);
#pragma unroll
  for (int q = 0; q < kPos; ++q) {
    const int k = static_cast<int>(kmer_ids[r * kPos + q]);
    x[kFeat + kEmb * q] = emb[kEmb * k];
    x[kFeat + kEmb * q + 1] = emb[kEmb * k + 1];
  }""",
         """  const float* row = emb + (r & 63);
#pragma unroll
  for (int i = 0; i < kIn; ++i) x[i] = row[i];"""),
        ("""  if (c < kFeat) return __ldg(features + r * kFeat + c);
  if (c >= kIn) return 0.f;
  const int k = static_cast<int>(kmer_ids[r * kPos + (c - kFeat) / kEmb]);
  return emb[kEmb * k + (c - kFeat) % kEmb];""",
         """  return c >= kIn ? 0.f : emb[(r & 63) + c];"""),
    ],
    # (b) layer 2's mma.sync and its B-fragment loads gone: each k step's A
    # fragments folded into the accumulators by one integer and one f32 op
    "b: no layer-2 mma": [
        ("""      const uint2 bl = w2l[(j * kTiles2 + nt) * 32 + lane];
      const uint2 bh = w2h[(j * kTiles2 + nt) * 32 + lane];
      mma_bf16(cross[nt], ahi, bl);
      mma_bf16(cross[nt], alo, bh);
      mma_step(high[nt], ahi, bh);""",
         """      cross[nt][nt] += __uint_as_float(ahi[nt] & 0x3f7fffffu);
      high[nt][nt] += __uint_as_float(alo[nt] & 0x3f7fffffu);"""),
        ("""    for (int nt = 0; nt < kTiles2; ++nt) mma_step(acc[nt], a2, w2h[(j * kTiles2 + nt) * 32 + lane]);""",
         """    for (int nt = 0; nt < kTiles2; ++nt) acc[nt][nt] += __uint_as_float(a2[nt] & 0x3f7fffffu);"""),
    ],
    # (c) layer 1 replaced by 4 operations a unit that read the same W1 rows
    # and all 15 inputs of each read (the same registers live); in bf16 its
    # two mma by a mix of the A fragment and the B fragments
    "c: layer-1 stand-in": [
        ("""        float u = a.x * in[0];  // fused_infer.cu's order
        u = fmaf(a.y, in[1], u);
        u = fmaf(a.z, in[2], u);
        u = fmaf(a.w, in[3], u);
        u = fmaf(b.x, in[4], u);
        u = fmaf(b.y, in[5], u);
        u = fmaf(b.z, in[6], u);
        u = fmaf(b.w, in[7], u);
        u = fmaf(cc.x, in[8], u);
        u = fmaf(cc.y, in[9], u);
        u = fmaf(cc.z, in[10], u);
        u = fmaf(cc.w, in[11], u);
        u = fmaf(d.x, in[12], u);
        u = fmaf(d.y, in[13], u);
        u = fmaf(d.z, in[14], u);
        h[c][i] = fmaxf(u + d.w, 0.f);  // + b1', relu""",
         """        h[c][i] = fmaxf(fmaf(a.x, in[c], fmaf(b.y, in[4 + c], fmaf(cc.z, in[8 + c], d.w * in[12 + c % 3]))),
                        0.f);"""),
        ("""    mma_bf16(c0, a1, w1h[(2 * j) * 32 + lane]);
    mma_bf16(c1, a1, w1h[(2 * j + 1) * 32 + lane]);""",
         """    {
      const uint2 b0 = w1h[(2 * j) * 32 + lane], b1v = w1h[(2 * j + 1) * 32 + lane];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c0[k] = __uint_as_float((a1[k] ^ b0.x) & 0x3f7fffffu);
        c1[k] = __uint_as_float((a1[k] ^ b1v.y) & 0x3f7fffffu);
      }
    }"""),
    ],
}

_WGMMA_ABLATIONS = {  # a persistent warp-specialised block on wgmma and bulk copies
    # (a) no bulk copy: the producer only arrives, and the consumers read
    # the stages' stale bytes as inputs (their shared-memory loads stay)
    "a: no bulk copies": [
        ("""        bar_arrive_tx(full, in.feat_bytes() + in.kmer_bytes());
        bulk_copy(stage, feat_base + item * C::kItemFeatBytes, in.feat_bytes(), full);
        bulk_copy(stage + C::kStageFeatBytes, kmer_base + item * C::kItemKmerBytes, in.kmer_bytes(), full);""",
         """        (void)stage;
        bar_arrive(full);"""),
    ],
    # (b) layer 2's wgmma gone: each k step's A fragments folded into the
    # accumulators by one integer op a register
    "b: no layer-2 wgmma": [
        ("""    wgmma<kH2Pad>(cross[tt], ahi[B][tt], dl, 1);  // W2lo.h1hi
    wgmma<kH2Pad>(cross[tt], alo[B][tt], dh, 1);  // + W2hi.h1lo
    wgmma<kH2Pad>(part[tt], ahi[B][tt], dh, 0);   // W2hi.h1hi alone""",
         """#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cross[tt][i] += __uint_as_float(ahi[B][tt][i] & 0x3f7fffffu);
      part[tt][i] = __uint_as_float(alo[B][tt][i] & 0x3f7fffffu);
    }
    (void)dl, (void)dh;"""),
        ("""  wgmma<kH2Pad>(part[0], a2[0], b_desc(w2h), 0);""",
         """  for (int i = 0; i < 4; ++i) part[0][i] = __uint_as_float(a2[0][i] & 0x3f7fffffu);"""),
        ("""      wgmma<kH2Pad>(part[(j + 1) & 1], a2[j + 1], b_desc(w2h + (j + 1) * kW2StepBytes), 0);""",
         """      for (int i = 0; i < 4; ++i) part[(j + 1) & 1][i] = __uint_as_float(a2[j + 1][i] & 0x3f7fffffu);"""),
    ],
    # (c) layer 1 cut to about 4 operations a unit that read the same W1 rows
    # (an FMA every fourth input at the released widths); in bf16 its
    # wgmma by a mix of the A fragment
    "c: layer-1 stand-in": [
        ("""            u[i] = fmaf(wq[e], x.at(i, k), u[i]);""",
         """            u[i] = k % 4 == 0 ? fmaf(wq[e], x.at(i, k), u[i]) : u[i];"""),
        ("""  for (int k1 = 0; k1 < kK1Steps; ++k1) layer1_bf16<0>(h, a1[k1], w1h + k1 * kW1StepBytes, k1 > 0 ? 1 : 0);""",
         """#pragma unroll
  for (int i = 0; i < kH1Pad / 2; ++i) h[i] = __uint_as_float((a1[0][i & 3] ^ (i << 7)) & 0x3f7fffffu);
  (void)w1h;"""),
    ],
    # (d) f32x3: every lane of a warp loads the W1 rows of thread t = 0, so
    # each LDS.128 reads one address (a broadcast) instead of four
    "d: one W1 row address a warp": [
        ("""    const float4* row = w1 + (J * 4 + c) * 4 * kW1Quads + t;  // [j][c][q][t]""",
         """    const float4* row = w1 + (J * 4 + c) * 4 * kW1Quads;  // [j][c][q][0] in every lane"""),
    ],
}
ABLATIONS = {"mma.sync": _MMA_SYNC_ABLATIONS, "wgmma": _WGMMA_ABLATIONS}


def reference_image(root: str, fp: fik.FusedParamsT) -> torch.Tensor:
    """The weight image that the copy of this package at ``root`` packs for
    its own kernel from ``fp``'s weights (its ``_pack_tc``, imported under
    another name beside this package)."""
    name = "m6anet_tpu_torch_reference"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "__init__.py"), submodule_search_locations=[root])
    package = importlib.util.module_from_spec(spec)
    sys.modules[name] = package
    spec.loader.exec_module(package)
    pack = importlib.import_module(f"{name}.ops.fused_infer_kernel")._pack_tc
    weights = {k: getattr(fp, k).cpu() for k in ("w1t", "embt", "b1t", "w2t", "b2t", "w3t", "b3t")}
    if "w" in inspect.signature(pack).parameters:  # a copy since widths became build-time macros
        weights["w"] = fp.widths
    return pack(**weights).to(fp.tc.device)


def ablation_builds(text: str):
    """(name, source) of every ablation whose lines ``text`` holds once each."""
    return [(name, ablation_source(text, patches))
            for ablations in ABLATIONS.values()
            if all(text.count(old) == 1 for patches in ablations.values() for old, _ in patches)
            for name, patches in ablations.items()]


def ablation_source(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"the reference has no single copy of the ablated lines:\n{old}")
        text = text.replace(old, new)
    return text


def _chunks(a: torch.Tensor, b: torch.Tensor, chunk_sum) -> torch.Tensor:
    out = None
    for k in range(0, a.shape[1], 16):
        part = chunk_sum(a[:, k : k + 16], b[:, k : k + 16])
        out = part if out is None else out + part
    return out


# how the plain version sums the products the kernel takes on the tensor cores
# into a zero accumulator (f32x3's cross products, in one accumulator, stay
# in fik._tensor_core_accumulate; scripts/probe_tc_sums.py varies both)
SUMS = {
    "k16 chunks, f64 sums truncated toward zero (the plain version)": fik._tensor_core_matmul,
    "k16 chunks, f64 sums rounded to nearest": lambda a, b: _chunks(
        a, b, lambda x, y: torch.matmul(x.double(), y.double().t()).float()),
    "k16 chunks, f32 matmuls": lambda a, b: _chunks(a, b, lambda x, y: torch.matmul(x, y.t())),
    "one f32 matmul": lambda a, b: torch.matmul(a, b.t()),
}


def _diff(p: torch.Tensor, q: torch.Tensor) -> dict:
    err = (p - q).abs()
    return {"identical": torch.equal(p, q), "reads_differing": int((err > 0).sum()),
            "max_abs_diff": float(err.max()) if err.numel() else 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", help="another read_prob_tc.cu, or the root of an earlier copy of this "
                    "package, to build, ablate and compare with")
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
    by_size = {b[0].shape[0]: b for tile in sorted({fik.read_tile_reads(m) for m in MODES})
               for b in fik.ragged_tail_batches(tile)}
    tails = [(torch.from_numpy(b[0]).cuda(), torch.from_numpy(b[1]).cuda()) for _, b in sorted(by_size.items())]

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
        builds = [("as checked in", source, False, fp.tc)]  # (label, source, ablation, image)
        ablated = [("as checked in", text, fp.tc)]
        if args.reference:
            reference = os.path.abspath(args.reference)
            ref_image = fp.tc
            if os.path.isdir(reference):
                ref_image = reference_image(reference, fp)
                reference = os.path.join(reference, "ops", "csrc", "read_prob_tc.cu")
            builds.insert(0, ("reference", reference, False, ref_image))
            with open(reference) as f:
                ablated.insert(0, ("reference", f.read(), ref_image))
        for label, source_text, image in ablated:
            for name, ablation_text in ablation_builds(source_text):
                path = os.path.join(tmp, f"read_prob_tc_{label.replace(' ', '_')}_ablation_{name[0]}.cu")
                with open(path, "w") as f:
                    f.write(ablation_text)
                builds.append((f"{label}, ablation {name}", path, True, image))
        for values in VARIANTS:
            path = os.path.join(tmp, "read_prob_tc_c{}_s{}_t{}_p{}.cu".format(*values))
            with open(path, "w") as f:
                f.write(variant_source(text, *variant_constants(values), "read_prob_tc.cu"))
            builds.append((dict(zip(VARIANT_KEYS, values)), path, False, fp.tc))
        command = [_build.nvcc_path(), *_build.NVCC_FLAGS]
        libs = _build.build_shared_libraries([(path, command) for _, path, _, _ in builds], out_dir=tmp)

        rows = []
        for (label, _, ablation, image), lib_path in zip(builds, libs):
            lib = _native.declare(lib_path, "read_prob_tc")
            # an older source may report no launch config
            configs = _native.open_library(lib, "read_prob_tc").plan if hasattr(lib, "read_prob_tc_config") else {}
            with open(lib_path + ".log") as f:
                serialized = [ln.strip() for ln in f if "wgmma" in ln and "serialized" in ln]
            for mode in MODES:
                code = fik.TC_MODES[mode]

                def launch(lib=lib, code=code, image=image, x=features, k=kmer, p=None):
                    err = lib.read_prob_tc_launch(
                        x.data_ptr(), k.data_ptr(), image.data_ptr(), p.data_ptr(),
                        x.shape[0], code, torch.cuda.current_stream().cuda_stream,
                    )
                    if err != 0:
                        raise RuntimeError(f"read_prob_tc_launch failed with CUDA error {err}")

                p = torch.empty(READS, dtype=torch.float32, device="cuda")
                launch(p=p)
                tail_p = []
                for x, k in tails:
                    tail_p.append(torch.empty(x.shape[0], dtype=torch.float32, device="cuda"))
                    launch(x=x, k=k, p=tail_p[-1])
                torch.cuda.synchronize()
                config = configs.get(mode)
                rows.append({
                    "build": label, "ablation": ablation, "precision": mode, "launch": lambda f=launch, p=p: f(p=p),
                    "p": p, "tails": tail_p, "config": config, "wgmma_serialized": serialized,
                    "ptxas": _build.ptxas_usage(lib_path, f"read_prob_tc_kernelILi{code}E"),
                })

        def compare(row, label):
            other = next(r for r in rows if r["build"] == label and r["precision"] == row["precision"])
            return {"batch": _diff(row["p"], other["p"]),
                    "tails": [_diff(a, b) for a, b in zip(row["tails"], other["tails"])]}

        for row in rows:  # each build alone first, so a fault names its build
            print(f"[launching] {row['build']} {row['precision']}", file=sys.stderr, flush=True)
            for _ in range(REPS):
                row["launch"]()
            torch.cuda.synchronize()
        times, clocks = time_interleaved([row["launch"] for row in rows], REPS)
        failed = []
        for row, row_times in zip(rows, times):
            half = len(row_times) // 2
            result = {
                "build": row["build"], "precision": row["precision"], "ptxas": row["ptxas"],
                "wgmma_serialized": row["wgmma_serialized"], "config": row["config"],
                "ms": statistics.median(row_times),
                "ms_by_round": [statistics.median(row_times[:half]), statistics.median(row_times[half:])],
                "finite": bool(torch.isfinite(row["p"]).all()),
            }
            if not row["ablation"]:
                same = compare(row, "as checked in")
                result["bit_identical_to_checked_in"] = same["batch"]["identical"] and all(
                    t["identical"] for t in same["tails"])
                if not result["bit_identical_to_checked_in"] or not result["finite"]:
                    failed.append((row["build"], row["precision"]))
                if args.reference:
                    result["vs_reference"] = compare(row, "reference")
            results.append(result)
            print(json.dumps(result), flush=True)
        summary = {"card": card, "reads": READS, "tail_reads": [x.shape[0] for x, _ in tails],
                   "sm_clock_after_each_round": clocks}
        print(json.dumps(summary), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "results": results}, f, indent=1)
        if failed:
            print(f"FAILED: builds whose p differs from the checked-in build's, or is not finite: {failed}",
                  file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
