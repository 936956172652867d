"""The work a step needs, counted from the function and not from any
implementation of it, and the card's peaks it is held against.

Every count is over the real reads and sites of a batch only: the padding
reads a batch carries are work the function does not ask for.

* Model operations per read: ``2 (n_in H1 + H1 H2 + H2)``, the three
  matrix products' multiply-adds (the embedding is a lookup, BatchNorm
  folds into the first layer, the activations are not counted).
* A train step's operations per read: three times that, the forward's
  products and the backward's two a layer (the gradient of the layer's
  input and of its weights; the first layer's input gradient reaches only
  the embedding, and is counted all the same, as a step needs it whenever
  the embedding trains).  BatchNorm, the loss and Adam are elementwise and
  not counted.
* Phase A (the per-read model) reads each read's inputs once (its float32
  features, its int8 k-mer ids) and writes its float32 p once.
* Phase B (exact site statistics) reads each real read's p, each site's
  offset and count once, and writes each site's site_p and mod_ratio once;
  its operations (one subtraction, one comparison and two additions a
  read) are far below its bytes.
* MC reads U, each real read's p and each site's offset and count once,
  and writes site_p once.  Its least operations: one multiplication a draw
  (each draw's factor 1 - p enters the product of its iteration) and one
  addition an iteration of a site (the sum over iterations).  The draw
  index is not counted: sites of one read count share their indices, so an
  implementation need not compute one a draw.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

# NVIDIA H100 SXM data sheet, dense: 67 TFLOP/s float32 outside the tensor
# cores, 989 TFLOP/s bf16 on them (f32x3 makes each float32 product of
# three bf16 products: a third of that), HBM3 at 3.35 TB/s.  Keyed by
# torch.cuda.get_device_name(); another card reads no roofline.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"f32": 67e12, "f32x3": 989e12 / 3, "bf16": 989e12, "bytes": 3.35e12},
}


class Widths(NamedTuple):
    n_in: int  # inputs a read gives the first layer
    h1: int
    h2: int


def model_widths(model_config: Dict) -> Widths:
    """The encoder's widths from a model config's block list: its first two
    ``Linear`` blocks."""
    linear = [b for b in model_config["block"] if b["block_type"] == "Linear"]
    return Widths(linear[0]["input_channel"], linear[0]["output_channel"], linear[1]["output_channel"])


def model_flops_per_read(w: Widths) -> int:
    return 2 * (w.n_in * w.h1 + w.h1 * w.h2 + w.h2)


def train_flops_per_read(w: Widths) -> int:
    return 3 * model_flops_per_read(w)


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)


def bound_s(kind: str, precision: str, ops: float, nbytes: float) -> Optional[float]:
    """The least time for the work: the larger of operations over the
    precision's peak and bytes over the memory's bandwidth; None on a card
    the table does not hold."""
    flops, bandwidth = peak(kind, precision), peak(kind, "bytes")
    if flops is None or bandwidth is None:
        return None
    return max(ops / flops, nbytes / bandwidth)


def phase_a(w: Widths, reads: float, features: int, positions: int):
    """(operations, bytes) of the per-read model over ``reads`` reads."""
    return model_flops_per_read(w) * reads, reads * (4 * features + positions + 4)


def phase_b(reads: float, sites: float):
    """(operations, bytes) of the exact site statistics."""
    return 4 * reads, 4 * reads + 16 * sites


def mc(reads: float, sites: float, n_iters: int, n_samples: int):
    """(operations, bytes) of the MC site probability."""
    return sites * n_iters * (n_samples + 1), 4 * n_samples * n_iters + 4 * reads + 12 * sites
