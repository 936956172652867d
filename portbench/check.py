"""The comparison that decides ``correct``: what the timed path left in each
staged batch's slot, against the plain reference (``reference/``) worked
out again from the same weights and batches.

Three numbers, each held to its limit (``limits/<workload>.json``):

* ``p_err``: the largest |p - p_ref| over the real reads of every batch,
  p_ref from the reference's model in float64;
* ``site_p_err``: the largest |site_p - site_p_ref| over the real sites,
  site_p_ref from p_ref (exact noisy-OR, or MC with the same draws U);
* ``mod_ratio_wrong``: the sites whose mod_ratio is not the share of the
  batch's own returned p at or above the threshold (an exact comparison:
  which reads lie on which side of the threshold is p's to answer, and
  p_err judges p).

A NaN anywhere reads as an infinite error.  The reference runs in blocks
of reads, one batch at a time, so that it fits beside the staged batches.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List, Sequence

import torch

from .reference import mlp, sites

READS_A_BLOCK = 1 << 18
NAMES = ("p_err", "site_p_err", "mod_ratio_wrong")


def reference_module(config_name: str):
    return importlib.import_module(f"{__package__}.reference.{config_name}")


def reference_outputs(ref, w, batch, threshold, method, n_samples, u, mode):
    """(p, site_p, mod_ratio) of the reference in ``mode`` for one staged
    batch ``(features, kmer_ids, offsets, counts)`` on the card."""
    features, kmer_ids, offsets, counts = batch
    p = torch.cat([
        ref.per_read_p(w, features[a : a + READS_A_BLOCK], kmer_ids[a : a + READS_A_BLOCK], mode)
        for a in range(0, features.shape[0], READS_A_BLOCK)
    ])
    return (p,) + sites.site_outputs(p, offsets, counts, threshold, method, n_samples, u)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    err = float(torch.max(torch.abs(a.double() - b.double())))
    return math.inf if math.isnan(err) else err


def batch_numbers(outputs, reference, offsets, counts, threshold) -> Dict[str, float]:
    """The three numbers of one batch: its outputs ``(p, site_p, mod_ratio)``
    against the reference's."""
    p, site_p, ratio = outputs
    ref_p, ref_site_p, _ = reference
    real_reads = int(counts.long().sum())
    real = counts > 0
    own = sites.mod_ratio(p.float(), offsets, counts, threshold)
    wrong = real & ~((ratio == own) | (torch.isnan(ratio) & torch.isnan(own)))
    return {
        "p_err": _max_err(p[:real_reads], ref_p[:real_reads]),
        "site_p_err": _max_err(site_p[real], ref_site_p[real]),
        "mod_ratio_wrong": float(wrong.sum()),
    }


def judge(config_name: str, weights, batches: Sequence, slots: Sequence, threshold: float, method: str,
          n_samples: int, u_host, device, control: bool = False) -> List[Dict[str, float]]:
    """Each batch's numbers, for the program's outputs in ``slots``; with
    ``control`` the reference in TF32 takes the program's place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = reference_module(config_name)
    w64 = mlp.tensors(weights, "f64", device)
    wctl = mlp.tensors(weights, "tf32", device) if control else None
    u = None if u_host is None else torch.as_tensor(u_host, device=device)
    numbers = []
    with torch.no_grad():
        for batch, outputs in zip(batches, slots):
            offsets, counts = batch[2], batch[3]
            reference = reference_outputs(ref, w64, batch, threshold, method, n_samples, u, "f64")
            if control:
                outputs = reference_outputs(ref, wctl, batch, threshold, method, n_samples, u, "tf32")
            numbers.append(batch_numbers(outputs, reference, offsets, counts, threshold))
            del reference, outputs
    return numbers


def worst(numbers: List[Dict[str, float]], names=NAMES) -> Dict[str, float]:
    return {name: max(n[name] for n in numbers) for name in names}
