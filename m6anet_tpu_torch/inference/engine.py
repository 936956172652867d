"""Batched inference on the device: dataset -> per-read and per-site CSVs.

The port of the JAX package's ``inference/engine.py`` (capability parity
with the reference engine, reference: m6anet/utils/inference_utils.py:14-140):
packed static-shape batches, one device step per batch computing per-read
probabilities, the closed-form noisy-OR site probability and mod_ratio, a
small in-flight pipeline, and one sequential CSV writer.

Output contract (reference: m6anet/scripts/inference.py:94-97):
  data.site_proba.csv:  transcript_id,transcript_position,n_reads,probability_modified,kmer,mod_ratio
  data.indiv_proba.csv: transcript_id,transcript_position,read_index,probability_modified
values at 16 decimal places.  The final batch is always flushed (the
reference's ``(it+1) % save_per_batch`` condition can drop it —
reference: m6anet/utils/inference_utils.py:47).

Backends (the JAX package's ``pallas_fused``, ``pallas`` and ``xla``):
``cuda_fused`` runs the whole step as the hand-written kernel of
``ops/fused_infer_kernel.py``; ``cuda`` runs only the per-read encoder as a
kernel (``ops/encoder_kernel.py``) and the plain site ops;
``torch`` runs the model's modules and the plain site ops.  With the MC site
method (``method="mc"``) both CUDA backends take the site probability from
the kernel of ``ops/mc_kernel.py``, and ``torch`` from
``site_ops.site_probability_mc``; the two draw different numbers for one
seed, as the JAX package's backends do.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.batching import DEFAULT_READ_CAPACITY, DEFAULT_SITE_CAPACITY, SiteBatch, pack_sites
from ..data.dataset import SiteDataset
from ..models.mil import MILModel
from ..ops import encoder_kernel, fused_infer_kernel, mc_kernel, random, site_ops
from ..ops.site_ops import derive_site_ids  # noqa: F401  (part of this module's API)
from ..utils.logging import get_logger
from ..utils.profiling import StageTimer

SITE_HEADER = "transcript_id,transcript_position,n_reads,probability_modified,kmer,mod_ratio\n"
INDIV_HEADER = "transcript_id,transcript_position,read_index,probability_modified\n"

BACKENDS = ("auto", "torch", "cuda_fused", "cuda")
METHODS = ("exact", "mc")
CUDA_BACKENDS = ("cuda_fused", "cuda")
PRECISIONS = ("auto", "f32")


def resolve_device(device) -> torch.device:
    """The device to run on.  CUDA is never silently replaced by the CPU:
    asking for it without a usable card raises.  On CUDA, TF32 is switched
    off for matmuls and convolutions (f32 parity, like the JAX package's
    HIGHEST-precision dots)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device}")
    return device


def fused_backend_supported(model: MILModel) -> bool:
    """True when the architecture matches the fused kernel's layout:
    Deaggregate -> KmerMultipleEmbedding(66 -> 2, 3 positions) -> Concat ->
    Linear(15 -> 150, relu, BN optional) -> Linear(150 -> 32, relu, no BN)
    -> SigmoidProdPooling — the production MILModel all four released
    models share."""
    names = [type(blk).__name__ for blk in model.blocks]
    if names != [
        "DeaggregateNanopolish", "KmerMultipleEmbedding", "ConcatenateFeatures",
        "Linear", "Linear", "SigmoidProdPooling",
    ]:
        return False
    emb, l1, l2 = model.blocks[1], model.blocks[3], model.blocks[4]
    return (
        emb.n_positions == fused_infer_kernel.N_POSITIONS
        and tuple(emb.embedding.weight.shape) == (fused_infer_kernel.VOCAB, fused_infer_kernel.EMB_DIM)
        and tuple(l1.linear.weight.shape) == (fused_infer_kernel.HIDDEN1, 15)
        and tuple(l2.linear.weight.shape) == (fused_infer_kernel.HIDDEN2, fused_infer_kernel.HIDDEN1)
        and l1.activation_name == "relu"
        and l2.activation_name == "relu"
        and l2.bn is None
    )


def resolve_backend(
    model: MILModel, backend: str, precision: str, device: torch.device, log=None
) -> Tuple[str, str]:
    """Resolve 'auto' backend/precision: the fused CUDA kernel on a card,
    the torch modules on the CPU.  The torch modules run on the card only
    when asked for by name: 'auto' (like 'cuda_fused' and 'cuda') raises on
    a card for an architecture the kernels do not cover."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r} (the f32x3 "
            "and bf16 modes wait: ROADMAP.md, Queue 1 'Reduced-precision modes')"
        )
    if backend == "auto":
        backend = "cuda_fused" if device.type == "cuda" else "torch"
    elif backend in CUDA_BACKENDS and device.type != "cuda":
        raise ValueError(f"backend {backend!r} needs device 'cuda'; use --backend torch on the CPU")
    if backend in CUDA_BACKENDS and not fused_backend_supported(model):
        raise ValueError(
            "the CUDA kernels support only the production architecture "
            "(the packaged m6anet.toml config); run this model config with "
            "--backend torch (its own kernels wait for ROADMAP.md, Queue 1 "
            "'Generic model path')"
        )
    precision = "f32"
    if log is not None:
        log.info("inference path: device=%s backend=%s precision=%s", device, backend, precision)
    return backend, precision


def make_infer_step(
    model: MILModel,
    site_capacity: int,
    threshold: float,
    n_samples: int = 20,
    method: str = "exact",
    backend: str = "torch",
    n_iterations: int = 1000,
    seed: int = 0,
):
    """Build the per-batch device function
    ``step(features, kmer_ids, offsets, counts) -> (p, site_p, mod_ratio)``
    on tensors already on the model's device.  ``kmer_ids`` may be int8.

    ``method="mc"`` replaces the exact site probability with the sampled
    estimator over ``n_iterations`` iterations drawn from ``seed``.  On the
    CUDA backends its draws ``U`` are made once here and stay on the device
    for every batch (as the JAX engine passes one key to every step), and
    every site count must be <= ``mc_kernel.MAX_SITE_READS``."""
    if method not in METHODS:
        raise ValueError(f"site_proba method must be one of {METHODS}, got {method!r}")
    if backend not in ("torch",) + CUDA_BACKENDS:
        raise ValueError(f"backend must be 'torch', 'cuda_fused' or 'cuda', got {backend!r}")
    if method == "mc" and n_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {n_iterations}")
    if backend == "torch":
        key = random.key_from_seed(seed)

        def step(features, kmer_ids, offsets, counts):
            site_ids = site_ops.derive_site_ids(offsets, counts, features.shape[0], site_capacity)
            p = model.per_read_probability({"X": features, "kmer": kmer_ids})
            if method == "mc":
                site_p = site_ops.site_probability_mc(p, offsets, counts, key, n_iterations, n_samples)
            else:
                site_p = site_ops.site_probability_exact(p, site_ids, counts, site_capacity, n_samples)
            mod_ratio = site_ops.mod_ratio_exact(p, site_ids, counts, site_capacity, threshold)
            return p, site_p, mod_ratio

        return step

    fp = fused_infer_kernel.prepare_fused_params_t(model)
    if method == "mc":
        u = torch.from_numpy(random.shared_draws(seed, n_iterations, n_samples)).to(fp.packed.device)

        def mc_site_p(p, offsets, counts):
            return mc_kernel.site_probability_mc_cuda(p, offsets, counts, u, n_iterations, n_samples)

    if backend == "cuda_fused":

        def fused_step(features, kmer_ids, offsets, counts):
            p, site_p, mod_ratio = fused_infer_kernel.fused_inference_t(
                fp, features, kmer_ids, None, offsets, counts, threshold, n_samples
            )
            if method == "mc":
                site_p = mc_site_p(p, offsets, counts)
            return p, site_p, mod_ratio

        return fused_step

    def encoder_step(features, kmer_ids, offsets, counts):
        p = encoder_kernel.fused_read_probability(fp, features, kmer_ids)
        site_ids = site_ops.derive_site_ids(offsets, counts, features.shape[0], site_capacity)
        if method == "mc":
            site_p = mc_site_p(p, offsets, counts)
        else:
            site_p = site_ops.site_probability_exact(p, site_ids, counts, site_capacity, n_samples)
        mod_ratio = site_ops.mod_ratio_exact(p, site_ids, counts, site_capacity, threshold)
        return p, site_p, mod_ratio

    return encoder_step


def _write_batch(batch: SiteBatch, p, site_p, mod_ratio, f_site, f_indiv):
    from ..native import native_render_indiv_csv_batch

    site_rows = []
    all_int_ids = True
    for i, site in enumerate(batch.sites):
        site_rows.append(
            "%s,%d,%s,%.16f,%s,%.16f\n"
            % (site.tx_id, site.tx_pos, batch.counts[i], site_p[i], site.center_kmer, mod_ratio[i])
        )
        all_int_ids = all_int_ids and site.read_ids.dtype == np.int64
    f_site.write("".join(site_rows))

    if f_indiv is None:  # site-only mode: p was never fetched
        return

    n_sites = len(batch.sites)
    counts = batch.counts[:n_sites]
    block = None
    if all_int_ids and n_sites:
        prefix_parts = [f"{s.tx_id},{s.tx_pos},".encode() for s in batch.sites]
        prefix_off = np.zeros(n_sites + 1, np.int64)
        np.cumsum([len(q) for q in prefix_parts], out=prefix_off[1:])
        # pack_sites lays reads out densely (site i at [offsets[i],
        # offsets[i]+counts[i]), no gaps), so the flat probability prefix
        # lines up with the concatenated read ids directly
        read_ids = np.concatenate([s.read_ids for s in batch.sites])
        block = native_render_indiv_csv_batch(
            b"".join(prefix_parts), prefix_off, counts,
            read_ids, p[: len(read_ids)],
        )
    if block is None:  # string read ids (replicates) or no native lib
        parts = []
        for i, site in enumerate(batch.sites):
            start = batch.offsets[i]
            parts.append(
                "".join(
                    "%s,%d,%s,%.16f\n"
                    % (site.tx_id, site.tx_pos, site.read_ids[r], p[start + r])
                    for r in range(batch.counts[i])
                )
            )
        block = "".join(parts).encode()
    f_indiv.write(block)


class _PendingBatch:
    """One dispatched batch: its site metadata and its outputs on their way
    to the host as ONE flat f32 buffer ([p,] site_p, mod_ratio)."""

    def __init__(self, batch: SiteBatch, outputs, device: torch.device):
        self.batch = batch
        self.sizes = [int(t.numel()) for t in outputs]
        flat = torch.cat([t.reshape(-1) for t in outputs])
        if device.type == "cuda":
            # one async device->host copy into pinned memory, ordered after
            # the step on the current stream; the event marks its end
            self.host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = flat, None

    def fetch(self):
        if self.done is not None:
            self.done.synchronize()
        flat = self.host.numpy()
        views, pos = [], 0
        for size in self.sizes:
            views.append(flat[pos : pos + size])
            pos += size
        return views


@torch.no_grad()
def run_inference(
    model: MILModel,
    dataset: SiteDataset,
    out_dir: str,
    read_proba_threshold: float,
    method: str = "exact",
    n_samples: int = 20,
    num_iterations: int = 1000,
    seed: int = 0,
    read_capacity: int = DEFAULT_READ_CAPACITY,
    site_capacity: int = DEFAULT_SITE_CAPACITY,
    pipeline_depth: int = 2,
    backend: str = "auto",
    precision: str = "auto",
    resume: bool = False,
    n_threads: int = 1,
    write_indiv: bool = True,
    device="cuda",
) -> None:
    """Run inference over every site of the dataset and write both CSVs.

    ``device`` defaults to the card; the model is moved there (in place)
    and set to eval mode.  ``resume=True`` continues an interrupted run:
    both CSVs are truncated to the last fully-written site and the dataset's
    already-scored prefix is skipped.  ``write_indiv=False`` writes only
    data.site_proba.csv, and per-read probabilities never leave the device.
    ``method="mc"`` samples the site probability (``num_iterations``
    iterations from ``seed``); its values depend only on the seed and each
    site's reads, not on how sites fall into batches.

    At most ``pipeline_depth`` batches are in flight: a new batch is
    dispatched only after the oldest beyond that bound is written.  Rows are
    written strictly in site order, one device->host copy per batch.
    """
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    timer = StageTimer()
    log = get_logger("m6anet_tpu_torch.inference")
    model.to(device).eval()
    backend, precision = resolve_backend(model, backend, precision, device, log=log)
    # every kernel wrapper's launch count, by the TPU kernel it ports
    kernels = {
        "fused_inference_t": (fused_infer_kernel, "launch_count"),
        "fused_read_probability": (encoder_kernel, "launch_count"),
        "site_probability_mc": (mc_kernel, "launch_count"),
        "fused_inference": (fused_infer_kernel, "fused_inference_launch_count"),
    }
    launches_before = {name: getattr(*counter) for name, counter in kernels.items()}

    # capacity validation at run setup, not mid-run from the packer (the
    # reference streams any site size — m6anet/utils/data_utils.py:226-229 —
    # so oversized sites must fail early with the flag to change)
    max_reads = getattr(dataset, "max_site_reads", None)
    if max_reads is not None and max_reads > read_capacity:
        raise ValueError(
            f"the dataset has a site with {max_reads} reads, above "
            f"read_capacity ({read_capacity}); raise --read_capacity, or cap "
            "sites at dataprep time with --readcount_max"
        )

    if (
        method == "mc" and backend in CUDA_BACKENDS
        and max_reads is not None and max_reads > mc_kernel.MAX_SITE_READS
    ):
        raise ValueError(
            f"the dataset has a site with {max_reads} reads, above the "
            f"{mc_kernel.MAX_SITE_READS} the MC kernel holds; cap sites at "
            "dataprep time with --readcount_max, or use --backend torch"
        )
    step = make_infer_step(
        model, site_capacity, read_proba_threshold, n_samples, method, backend,
        n_iterations=num_iterations, seed=seed,
    )

    site_path = os.path.join(out_dir, "data.site_proba.csv")
    indiv_path = os.path.join(out_dir, "data.indiv_proba.csv")

    n_done = 0
    file_mode = "w"
    if (
        resume
        and os.path.exists(site_path)
        and (not write_indiv or os.path.exists(indiv_path))
    ):
        n_done = _prepare_resume(site_path, indiv_path if write_indiv else None)
        # nothing valid survived (e.g. the first run died before the header
        # was flushed): start over in "w" mode so headers are written
        file_mode = "a" if n_done > 0 else "w"
        log.info("resuming: %d sites already scored", n_done)

    def sites_to_score():
        # the native data.json parser releases the GIL, so payload parsing
        # scales with host threads (the reference's DataLoader num_workers,
        # m6anet/scripts/inference.py:104-105)
        it = dataset.iter_sites(n_threads=n_threads)
        for _ in range(n_done):
            next(it)
        yield from it

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    # indiv file is binary: its rows are rendered natively as bytes
    with open(site_path, file_mode, encoding="utf-8") as f_site, (
        open(indiv_path, file_mode + "b")
        if write_indiv
        else contextlib.nullcontext(None)
    ) as f_indiv:
        if file_mode == "w":
            f_site.write(SITE_HEADER)
            if f_indiv is not None:
                f_indiv.write(INDIV_HEADER.encode())

        inflight: deque = deque()
        max_inflight = max(1, pipeline_depth)
        n_batches = 0

        def drain():
            pending = inflight.popleft()
            with timer.stage("write"):
                views = pending.fetch()
                if not write_indiv:
                    views = [None] + views
                _write_batch(pending.batch, *views, f_site=f_site, f_indiv=f_indiv)

        from ..data.prefetch import threaded_iter

        packed = pack_sites(
            sites_to_score(), read_capacity=read_capacity, site_capacity=site_capacity
        )
        batches = threaded_iter(packed, depth=pipeline_depth + 1)
        for batch in _timed_iter(timer, "featurize+pack", batches):
            # derive_site_ids treats count 0 as padding: a real site with no
            # reads would shift the ids of every site after it
            if (batch.counts[: batch.n_sites] < 1).any():
                raise ValueError("a packed batch holds a site with no reads")
            while len(inflight) >= max_inflight:
                drain()
            with timer.stage("dispatch"):
                kmer = batch.kmer_ids
                if kmer.dtype != np.int8:
                    kmer = kmer.astype(np.int8)
                p, site_p, mod_ratio = step(
                    to_device(batch.features), to_device(kmer),
                    to_device(batch.offsets), to_device(batch.counts),
                )
                outputs = (p, site_p, mod_ratio) if write_indiv else (site_p, mod_ratio)
                # CSV rendering needs only sites/offsets/counts: drop the
                # host-side packed feed arrays now
                batch.features = batch.kmer_ids = batch.site_ids = None
                inflight.append(_PendingBatch(batch, outputs, device))
                n_batches += 1
        while inflight:
            drain()
    launches = {name: getattr(*counter) - launches_before[name] for name, counter in kernels.items()}
    log.info("inference stages: %s", timer.summary())
    log.info("batches dispatched: %d", n_batches)
    log.info("kernel launches: %s", json.dumps(launches))


def _timed_iter(timer: "StageTimer", name: str, it):
    """Attribute generator-side (host featurization) time to a stage."""
    it = iter(it)
    while True:
        with timer.stage(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _prepare_resume(site_path: str, indiv_path: Optional[str]) -> int:
    """Truncate both CSVs to the last complete site; return its count.
    ``indiv_path=None`` (site-only mode) truncates the site CSV alone.

    The site CSV is the source of truth: any site row after the last newline
    is dropped, then the indiv CSV is truncated to exactly the rows of the
    surviving sites (rows are written grouped per site, in order).  Both
    files are processed in fixed-size chunks — resuming a giant run must not
    materialize gigabytes or loop Python once per read row.
    """
    CHUNK = 1 << 24
    n_done = 0
    expected_reads = 0
    with open(site_path, "rb+") as f:
        offset = len(f.readline())  # header (0 for an empty file)
        tail = b""
        while True:
            chunk = f.read(CHUNK)
            if not chunk:
                break
            chunk = tail + chunk
            lines = chunk.split(b"\n")
            tail = lines.pop()  # partial last line (possibly b"")
            for ln in lines:
                offset += len(ln) + 1
                n_done += 1
                try:
                    expected_reads += int(ln.split(b",")[2])
                except (IndexError, ValueError) as e:
                    raise RuntimeError(
                        f"site_proba.csv row {n_done} is malformed "
                        f"({ln[:80]!r}); cannot resume — rerun without "
                        "--resume"
                    ) from e
        f.truncate(offset)  # drops any torn trailing row

    if indiv_path is None:
        return n_done

    with open(indiv_path, "rb+") as f:
        offset = len(f.readline())
        remaining = expected_reads
        while remaining > 0:
            chunk = f.read(CHUNK)
            if not chunk:
                raise RuntimeError(
                    "indiv_proba.csv is shorter than site_proba.csv implies; "
                    "cannot resume — rerun without resume"
                )
            n = chunk.count(b"\n")
            if n >= remaining:
                pos = -1
                for _ in range(remaining):
                    pos = chunk.find(b"\n", pos + 1)
                offset += pos + 1
                remaining = 0
            else:
                offset += len(chunk)
                remaining -= n
        f.truncate(offset)
    return n_done


def merge_host_shards(out_dir: str, n_hosts: int, write_indiv: bool = True) -> None:
    """Concatenate per-host CSV shards (``*.csv.shard<i>``) into the final
    output files, keeping the reference's append-only CSV contract."""
    names = [("data.site_proba.csv", SITE_HEADER)]
    if write_indiv:
        names.append(("data.indiv_proba.csv", INDIV_HEADER))
    for name, header in names:
        with open(os.path.join(out_dir, name), "wb") as out:
            out.write(header.encode())
            for host in range(n_hosts):
                shard = os.path.join(out_dir, f"{name}.shard{host}")
                with open(shard, "rb") as f:
                    f.readline()  # strip shard header
                    shutil.copyfileobj(f, out, 16 << 20)  # bulk binary copy
