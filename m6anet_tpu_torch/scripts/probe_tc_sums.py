"""Which roundings of ``ops/csrc/read_prob_tc.cu`` its plain version leaves
out, model by model, on one card.

    python -m m6anet_tpu_torch.scripts.probe_tc_sums [--full] [--out FILE.json]

For each released model (its own weights, threshold and norm factors) and
each reduced mode (f32x3, bf16) it runs the tensor-core kernel on the demo's
reads packed as the engine packs them (and, with ``--full``, on the
production batch of ``_sweep.production_batch``), and holds its p against:

* ``plain``: ``fused_infer_kernel.read_probability_plain``, the plain
  version: every sum in the kernel's order (layer 1's FMA chain, f32x3's
  cross products in one tensor-core accumulator, the head's per-lane FMAs
  and quad shuffles), each k16 step of the tensor cores summed exactly and
  truncated toward zero to f32;
* ``order/align<b>_g<g>``: the same, but each k16 step in groups of ``g``
  products, each group's products and the running sum aligned to the
  largest exponent among them and cut toward zero to 24 + ``b``
  significant bits, then summed and truncated to f32 (the alignment the
  tensor cores' adders are reported to make);
* ``matmul_order``: the plain version as it stood before it took the
  kernel's order (layer 1, f32x3's cross products and the head as f32
  matmuls);
* ``f64``: an f64 copy of the model.

For each: the largest |p - p_kernel|, the reads more than 1e-6 and 1e-7
apart and the reads that differ at all.  At the read where the kernel and
``matmul_order`` differ most, and at the one where the kernel and ``plain``
do, it prints p and z = logit(p) of the kernel, of every variant and of f64
(the witnesses).  Prints one JSON line each and
the card's ``nvidia-smi`` name and power limit; ``--out`` also writes them
to a file.  Needs one NVIDIA card and nvcc.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import tomllib
from unittest import mock

import torch

from ..constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
from ..data.batching import pack_sites
from ..data.dataset import build_dataset
from ..models import load_model
from ..ops import fused_infer_kernel as fik
from . import _sweep

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "tests", "data")
SUMS = [f"align{b}_g{g}" for g in (16, 8, 4) for b in (0, 1, 2, 3)]
CHUNK_READS = 1 << 16  # reads per slice of the f64 product tensors


def tc_step(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, how: str) -> torch.Tensor:
    """One k16 step of the tensor cores: ``acc + a @ b.T`` (``a`` (N, k),
    ``b`` (M, k), k <= 16, bf16 values in f32; ``acc`` (N, M) f32) summed as
    ``how`` says (module docstring)."""
    prods = a.double()[:, None, :] * b.double()[None, :, :]  # (N, M, k), exact
    bits, group = (int(s) for s in how[len("align"):].split("_g"))
    out = acc
    for k in range(0, prods.shape[-1], group):
        terms = torch.cat([out.double()[..., None], prods[..., k : k + group]], dim=-1)
        top = terms.abs().amax(-1, keepdim=True)
        _, exp = torch.frexp(top)  # top = m 2**exp, m in [0.5, 1)
        quantum = torch.where(top > 0, torch.ldexp(torch.ones_like(top), exp - 24 - bits), torch.ones_like(top))
        out = fik._round_toward_zero((torch.trunc(terms / quantum) * quantum).sum(-1))
    return out


def summed(how: str):
    """Replacements for the plain version's two tensor-core sums that sum
    each k16 step as ``how`` says."""
    def accumulate(acc, a, b):
        for k in range(0, a.shape[1], 16):
            acc = tc_step(acc, a[:, k : k + 16], b[:, k : k + 16], how)
        return acc

    def matmul(a, b):
        out = None
        for k in range(0, a.shape[1], 16):
            zero = a.new_zeros(a.shape[0], b.shape[0])
            part = tc_step(zero, a[:, k : k + 16], b[:, k : k + 16], how)
            out = part if out is None else out + part
        return out

    return mock.patch.multiple(fik, _tensor_core_accumulate=accumulate, _tensor_core_matmul=matmul)


def matmul_order_p(fp: fik.FusedParamsT, features: torch.Tensor, kmer_ids: torch.Tensor,
                   precision: str) -> torch.Tensor:
    """The plain version as it stood before it took the kernel's order:
    layer 1, f32x3's cross products and the head as f32 matmuls (the
    tensor cores' own products as ``fik._tensor_core_matmul``)."""
    n = features.shape[0]
    table = fp.embt.t()
    if precision == "f32x3":
        hi, lo = fik.bf16_split(table)
        table = hi + lo
    else:
        table = fik.bf16_round(table)
    x = torch.cat([features, table[kmer_ids.long()].reshape(n, -1)], dim=1)

    def dot(a, b, tensor_cores=False):
        if precision == "bf16":
            a, b = fik.bf16_round(a), fik.bf16_round(b)
            return fik._tensor_core_matmul(a, b) if tensor_cores else torch.matmul(a, b.t())
        a_hi, a_lo = fik.bf16_split(a)
        b_hi, b_lo = fik.bf16_split(b)
        high = fik._tensor_core_matmul(a_hi, b_hi) if tensor_cores else torch.matmul(a_hi, b_hi.t())
        return (torch.matmul(a_hi, b_lo.t()) + torch.matmul(a_lo, b_hi.t())) + high

    if precision == "bf16":
        h = torch.relu(dot(x, fp.w1t, tensor_cores=True) + fp.b1t.t())
    else:
        h = torch.relu(torch.matmul(x, fp.w1t.t()) + fp.b1t.t())
    h = torch.relu(dot(h, fp.w2t, tensor_cores=True) + fp.b2t.t())
    return torch.sigmoid(dot(h, fp.w3t) + fp.b3t.t()).reshape(-1)


def sliced(fn, features, kmer_ids, *args):
    return torch.cat([fn(features[i : i + CHUNK_READS], kmer_ids[i : i + CHUNK_READS], *args)
                      for i in range(0, features.shape[0], CHUNK_READS)])


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double()
    return torch.log(p) - torch.log1p(-p)


def probe(model, fp, batch, precision, label, emit):
    features, kmer, offsets, counts = (torch.from_numpy(a).cuda() for a in batch)
    n = int(counts.sum())
    features, kmer = features[:n], kmer[:n]
    got = torch.empty(n, device="cuda")
    fik.launch_read_prob_tc(fp, features, kmer, got, precision)
    with torch.no_grad():
        ref = {"plain": fik.read_probability_plain(fp, features, kmer, precision),
               "matmul_order": sliced(lambda f, k: matmul_order_p(fp, f, k, precision), features, kmer)}
        for how in SUMS:
            with summed(how):
                ref[f"order/{how}"] = sliced(lambda f, k: fik.read_probability_plain(fp, f, k, precision),
                                             features, kmer)
        exact = copy.deepcopy(model).double()
        ref["f64"] = torch.cat([exact.per_read_probability({"X": features[i : i + CHUNK_READS].double(),
                                                            "kmer": kmer[i : i + CHUNK_READS].long()})
                                for i in range(0, n, CHUNK_READS)])
    torch.cuda.synchronize()
    for name, p in ref.items():
        err = (got.double() - p.double()).abs()
        emit({"model": label[0], "batch": label[1], "precision": precision, "against": name, "reads": n,
              "max_abs_dp": float(err.max()), "reads_over_1e-6": int((err > 1e-6).sum()),
              "reads_over_1e-7": int((err > 1e-7).sum()), "reads_differing": int((err > 0).sum())})
    for against in ("matmul_order", "plain"):
        worst = int((got - ref[against]).abs().argmax())
        emit({"model": label[0], "batch": label[1], "precision": precision, "witness_against": against,
              "read": worst, "p": {"kernel": float(got[worst]), **{k: float(v[worst]) for k, v in ref.items()}},
              "z": {"kernel": float(logit(got[worst])), **{k: float(logit(v[worst])) for k, v in ref.items()}}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="also the production batch (1,048,576 reads)")
    ap.add_argument("--models", nargs="*", default=sorted(PRETRAINED_CONFIGS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"card": _sweep.smi("name,power.limit")})
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        config = tomllib.load(f)
    for name in args.models:
        weights, _, norm = PRETRAINED_CONFIGS[name]
        model = load_model(config, weights).cuda().eval()
        fp = fik.prepare_fused_params_t(model)
        dataset = build_dataset(DATA_DIR, min_reads=20, norm_path=norm, mode="Inference")
        (b,) = pack_sites(dataset.iter_sites(), read_capacity=8192, site_capacity=128)
        batches = [("demo", (b.features, fik.checked_kmer_ids(b.kmer_ids).ids, b.offsets, b.counts))]
        if args.full:
            batches.append(("production", _sweep.production_batch()))
        for label, batch in batches:
            for precision in ("f32x3", "bf16"):
                probe(model, fp, batch, precision, (name, label), emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(obj) for obj in lines) + "\n")


if __name__ == "__main__":
    main()
