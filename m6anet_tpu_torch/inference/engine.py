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
``torch`` runs the model's modules and the plain site ops, for any model
config whose pooling filter has a per-read probability layer; on a card
its step computes a model's last two relu ``Linear`` blocks and that layer
in one kernel where the kernel takes them
(``encoder_kernel.tail_read_probability``), and the exact site method in
phase B's kernel (``fused_infer_kernel.site_reduce``).  The CUDA
kernels cover the production architecture at any widths (but a vocabulary
past 32,767 k-mers or a read of more than 1,816 inputs:
``fused_infer_kernel.kernel_limit``), each set of widths built at first
use, as the JAX package's Pallas kernel takes any; a config of other
blocks resolves to ``torch``, as the JAX package's go to ``xla``
(``resolve_backend``).  With the MC site
method (``method="mc"``) both CUDA backends take the site probability from
the kernel of ``ops/mc_kernel.py``, and ``torch`` from
``site_ops.site_probability_mc``; the two draw different numbers for one
seed, as the JAX package's backends do.

Precisions (the JAX package's ``--precision``): ``f32`` everywhere, and on
the CUDA backends ``f32x3`` and ``bf16``, whose per-read phase runs on the
tensor-core kernel of ``ops/csrc/read_prob_tc.cu``; ``auto`` is ``f32x3``
on the CUDA backends and ``f32`` on ``torch``.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
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
from ..parallel.mesh import host_shard_bounds
from ..utils.logging import get_logger
from ..utils.profiling import StageTimer, device_trace, span

SITE_HEADER = "transcript_id,transcript_position,n_reads,probability_modified,kmer,mod_ratio\n"
INDIV_HEADER = "transcript_id,transcript_position,read_index,probability_modified\n"

BACKENDS = ("auto", "torch", "cuda_fused", "cuda")
METHODS = ("exact", "mc")
CUDA_BACKENDS = ("cuda_fused", "cuda")
PRECISIONS = ("auto",) + fused_infer_kernel.PRECISIONS


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


def production_architecture(model: MILModel) -> bool:
    """True when the block types and activations are the production
    MILModel's: Deaggregate -> KmerMultipleEmbedding -> Concat ->
    Linear(relu, BN optional) -> Linear(relu, no BN) -> SigmoidProdPooling,
    at any widths.  This is the JAX package's own test for its fused Pallas
    kernel, which takes any width of this architecture."""
    names = [type(blk).__name__ for blk in model.blocks]
    if names != [
        "DeaggregateNanopolish", "KmerMultipleEmbedding", "ConcatenateFeatures",
        "Linear", "Linear", "SigmoidProdPooling",
    ]:
        return False
    l1, l2 = model.blocks[3], model.blocks[4]
    return l1.activation_name == "relu" and l2.activation_name == "relu" and l2.bn is None


def resolve_backend(
    model: MILModel, backend: str, precision: str, device: torch.device, log=None
) -> Tuple[str, str]:
    """Resolve 'auto' backend/precision, from the architecture, before
    anything launches.  On a card: the fused CUDA kernel at f32x3 for the
    production architecture at any widths (the JAX package's ``auto``
    takes ``pallas_fused`` for it), and the torch modules at f32 for an
    architecture of other block types or activations (the JAX package's
    ``auto`` takes ``xla`` for the same configs).  The production
    architecture at widths ``fused_infer_kernel.kernel_limit`` names (a
    vocabulary past the int16 k-mer ids, a read of more than 1,816 inputs)
    raises, naming the widths and the limit (``--backend torch`` runs it).
    On the CPU the torch modules at f32.  An explicit CUDA backend for an
    architecture its kernels do not cover raises.  f32x3 and bf16 need a
    CUDA backend, as the JAX package's need a Pallas one."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if backend == "auto" and device.type == "cuda":
        backend = "cuda_fused" if production_architecture(model) else "torch"
    elif backend == "auto":
        backend = "torch"
    elif backend in CUDA_BACKENDS and device.type != "cuda":
        raise ValueError(f"backend {backend!r} needs device 'cuda'; use --backend torch on the CPU")
    elif backend in CUDA_BACKENDS and not production_architecture(model):
        raise ValueError(
            f"backend {backend!r}: the CUDA kernels support only the production "
            "architecture (the packaged m6anet.toml config's blocks); run this "
            "model config with --backend torch"
        )
    if backend in CUDA_BACKENDS:
        fused_infer_kernel.check_widths(fused_infer_kernel.model_widths(model))
    if precision == "auto":
        precision = "f32x3" if backend in CUDA_BACKENDS else "f32"
    elif precision != "f32" and backend not in CUDA_BACKENDS:
        raise ValueError(
            f"precision {precision!r} runs on the CUDA backends ('cuda_fused', "
            "'cuda') and the production architecture; --backend torch computes in f32"
        )
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
    precision: str = "f32",
):
    """Build the per-batch device function
    ``step(features, kmer_ids, offsets, counts, host_sites=None, host_kmer_ids=None)
    -> (p, site_p, mod_ratio)`` on tensors already on the model's device.
    ``kmer_ids`` may be int8.  ``host_sites`` is ``(offsets, counts)`` as the
    numpy arrays the tensors were copied from; the MC kernel's wrapper then
    checks the sites on the host, with no host sync.  ``host_kmer_ids`` is
    ``fused_infer_kernel.checked_kmer_ids`` of the array ``kmer_ids`` was
    copied from; the CUDA backends' encoder wrappers then make no host sync.

    ``method="mc"`` replaces the exact site probability with the sampled
    estimator over ``n_iterations`` iterations drawn from ``seed``.  On the
    CUDA backends its draws ``U`` are made once here and stay on the device
    for every batch (as the JAX engine passes one key to every step); a
    site may hold up to ``mc_kernel.MAX_SITE_READS`` reads, and any
    ``n_samples`` from 1 builds its own MC kernel at first use.

    ``precision`` is the CUDA backends' (``f32``, ``f32x3`` or ``bf16``);
    the torch backend takes only ``f32``, and a model whose pooling filter
    has a per-read probability layer (it raises the JAX package's error
    for any other).  On a card the torch step folds and packs the model's
    per-read tail here, once (``encoder_kernel.tail_params``), so it holds
    the model's weights as they are when the step is built, as the CUDA
    backends' steps do; there its exact site method is phase B's kernel,
    the site ops' bits."""
    if method not in METHODS:
        raise ValueError(f"site_proba method must be one of {METHODS}, got {method!r}")
    if backend not in ("torch",) + CUDA_BACKENDS:
        raise ValueError(f"backend must be 'torch', 'cuda_fused' or 'cuda', got {backend!r}")
    if method == "mc" and n_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {n_iterations}")
    fused_infer_kernel.check_precision(precision)
    if backend == "torch" and precision != "f32":
        raise ValueError(f"precision {precision!r} runs on the CUDA backends; backend 'torch' computes in f32")
    calls = itertools.count()  # the id of each call's engine.step span
    if backend == "torch":
        model.per_read_filter()  # the JAX package's error, before any batch
        key = random.key_from_seed(seed)
        tail = encoder_kernel.tail_params(model)
        if tail is None:
            per_read_probability = model.per_read_probability
        else:  # on the card: the blocks before the tail as modules, the tail in one kernel
            per_read_probability = functools.partial(encoder_kernel.tail_read_probability, tail)

        def step(features, kmer_ids, offsets, counts, host_sites=None, host_kmer_ids=None):
            with span("engine.step", next(calls)):
                with span("model.per_read_probability"):
                    p = per_read_probability({"X": features, "kmer": kmer_ids})
                if method == "exact" and p.is_cuda:
                    # phase B of the CUDA backends: the site ops' bits for p in [0, 1] or NaN
                    site_p, mod_ratio = fused_infer_kernel.site_reduce(p, offsets, counts, threshold, n_samples)
                    return p, site_p, mod_ratio
                with span("site_ops.derive_site_ids"):
                    site_ids = site_ops.derive_site_ids(offsets, counts, features.shape[0], site_capacity)
                if method == "mc":
                    with span("site_ops.site_probability_mc"):
                        site_p = site_ops.site_probability_mc(p, offsets, counts, key, n_iterations, n_samples)
                else:
                    with span("site_ops.site_probability_exact"):
                        site_p = site_ops.site_probability_exact(p, site_ids, counts, site_capacity, n_samples)
                with span("site_ops.mod_ratio_exact"):
                    mod_ratio = site_ops.mod_ratio_exact(p, site_ids, counts, site_capacity, threshold)
                return p, site_p, mod_ratio

        return step

    fp = fused_infer_kernel.prepare_fused_params_t(model)
    if method == "mc":
        u = torch.from_numpy(random.shared_draws(seed, n_iterations, n_samples)).to(fp.packed.device)

        def mc_site_p(p, offsets, counts, host_sites):
            return mc_kernel.site_probability_mc_cuda(
                p, offsets, counts, u, n_iterations, n_samples, host_sites=host_sites
            )

    if backend == "cuda_fused":

        def fused_step(features, kmer_ids, offsets, counts, host_sites=None, host_kmer_ids=None):
            with span("engine.step", next(calls)):
                p, site_p, mod_ratio = fused_infer_kernel.fused_inference_t(
                    fp, features, kmer_ids, None, offsets, counts, threshold, n_samples, precision,
                    host_kmer_ids=host_kmer_ids,
                )
                if method == "mc":
                    site_p = mc_site_p(p, offsets, counts, host_sites)
                return p, site_p, mod_ratio

        return fused_step

    def encoder_step(features, kmer_ids, offsets, counts, host_sites=None, host_kmer_ids=None):
        with span("engine.step", next(calls)):
            p = encoder_kernel.fused_read_probability(
                fp, features, kmer_ids, precision, host_kmer_ids=host_kmer_ids
            )
            site_ids = site_ops.derive_site_ids(offsets, counts, features.shape[0], site_capacity)
            if method == "mc":
                site_p = mc_site_p(p, offsets, counts, host_sites)
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
    host_shard: Optional[Tuple[int, int]] = None,
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

    ``host_shard=(host_id, n_hosts)`` is the multi-process mode: this
    process scores its contiguous slice of the global site index
    (``parallel.mesh.host_shard_bounds``) and writes ``*.csv.shard{host_id}``
    files, which :func:`merge_host_shards` joins; ``resume`` then works
    within the shard's own files.  MC draws depend only on the seed and each
    site's reads, so the merged CSVs do not depend on the shard layout.

    A dataset with ``iter_packed`` (the columnar store) packs its batches
    itself, straight from its memory map: the same arrays as ``pack_sites``
    gives over its sites, without the per-site Python of the generic feed.
    """
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    timer = StageTimer()
    pack_timer = StageTimer(span_prefix="data.")  # the pack thread's own
    log = get_logger("m6anet_tpu_torch.inference")
    model.to(device).eval()
    backend, precision = resolve_backend(model, backend, precision, device, log=log)
    # every kernel wrapper's launch count, by the TPU kernel it ports, the
    # tensor-core phase A's, by precision, those of a phase A of the wide
    # plan, by precision, those of an f32 phase A that shares h1 across lane
    # groups, and the MC long-site kernel's
    kernels = {
        "fused_inference_t": lambda: fused_infer_kernel.launch_count,
        "fused_read_probability": lambda: encoder_kernel.launch_count,
        "read_prob_tail": lambda: encoder_kernel.tail_launch_count,
        "site_probability_mc": lambda: mc_kernel.launch_count,
        "fused_inference": lambda: fused_infer_kernel.fused_inference_launch_count,
        "site_reduce": lambda: fused_infer_kernel.site_reduce_launch_count,
        **{
            f"read_prob_tc_{mode}": (lambda mode=mode: fused_infer_kernel.tc_launch_counts[mode])
            for mode in fused_infer_kernel.tc_launch_counts
        },
        **{
            f"read_prob_wide_{precision}": (lambda precision=precision: fused_infer_kernel.wide_launch_counts[precision])
            for precision in fused_infer_kernel.wide_launch_counts
        },
        "read_prob_grouped": lambda: fused_infer_kernel.grouped_launch_count,
        "site_probability_mc_long": lambda: mc_kernel.long_launch_count,
    }
    launches_before = {name: count() for name, count in kernels.items()}

    shard_suffix = ""
    global_offset = 0
    n_total_sites = None
    if host_shard is not None:
        host_id, n_hosts = host_shard
        if not 0 <= host_id < n_hosts:
            raise ValueError(f"host_shard: host id {host_id} is outside [0, {n_hosts})")
        lo, hi = host_shard_bounds(len(dataset), n_hosts, host_id)
        global_offset = lo
        n_total_sites = hi - lo
        shard_suffix = f".shard{host_id}"
        log.info("host %d/%d scoring sites [%d, %d)", host_id, n_hosts, lo, hi)

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

    step = make_infer_step(
        model, site_capacity, read_proba_threshold, n_samples, method, backend,
        n_iterations=num_iterations, seed=seed, precision=precision,
    )

    site_path = os.path.join(out_dir, "data.site_proba.csv" + shard_suffix)
    indiv_path = os.path.join(out_dir, "data.indiv_proba.csv" + shard_suffix)

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
        for _ in range(global_offset + n_done):
            next(it)
        if n_total_sites is None:
            yield from it
        else:
            yield from itertools.islice(it, n_total_sites - n_done)

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    # indiv file is binary: its rows are rendered natively as bytes;
    # M6ANET_TPU_TRACE_DIR traces the batch loop (utils/profiling.py)
    with device_trace(), open(site_path, file_mode, encoding="utf-8") as f_site, (
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
            number, pending = inflight.popleft()
            with timer.stage("write", number):
                views = pending.fetch()
                if not write_indiv:
                    views = [None] + views
                _write_batch(pending.batch, *views, f_site=f_site, f_indiv=f_indiv)

        from ..data.prefetch import threaded_iter

        vocab = (fused_infer_kernel.model_widths(model).vocab if backend in CUDA_BACKENDS
                 else fused_infer_kernel.VOCAB)

        def checked(batches):
            # the k-mer range check, on the pack thread: the dispatch stage
            # then launches with no host sync and no host scan of the ids
            for batch in batches:
                yield batch, fused_infer_kernel.checked_kmer_ids(batch.kmer_ids, vocab)

        if hasattr(dataset, "iter_packed"):
            # the columnar feed: whole batches straight off the memory map
            limit = None if n_total_sites is None else n_total_sites - n_done
            packed = dataset.iter_packed(global_offset + n_done, limit, read_capacity, site_capacity)
        else:
            packed = pack_sites(
                sites_to_score(), read_capacity=read_capacity, site_capacity=site_capacity
            )
        # the pack thread's busy time: making each batch, span data.pack
        batches = threaded_iter(_timed_iter(pack_timer, "pack", checked(packed)), depth=pipeline_depth + 1)
        for batch, host_kmer in _timed_iter(timer, "featurize+pack", batches):
            # derive_site_ids treats count 0 as padding: a real site with no
            # reads would shift the ids of every site after it
            if (batch.counts[: batch.n_sites] < 1).any():
                raise ValueError("a packed batch holds a site with no reads")
            while len(inflight) >= max_inflight:
                drain()
            with timer.stage("dispatch", n_batches):
                p, site_p, mod_ratio = step(
                    to_device(batch.features), to_device(host_kmer.ids),
                    to_device(batch.offsets), to_device(batch.counts),
                    host_sites=(batch.offsets, batch.counts), host_kmer_ids=host_kmer,
                )
                outputs = (p, site_p, mod_ratio) if write_indiv else (site_p, mod_ratio)
                # CSV rendering needs only sites/offsets/counts: drop the
                # host-side packed feed arrays now
                batch.features = batch.kmer_ids = batch.site_ids = None
                inflight.append((n_batches, _PendingBatch(batch, outputs, device)))
                n_batches += 1
        while inflight:
            drain()
    launches = {name: count() - launches_before[name] for name, count in kernels.items()}
    log.info("inference stages: %s", timer.summary())
    log.info("pack thread: %s", pack_timer.summary())
    log.info("batches dispatched: %d", n_batches)
    log.info("kernel launches: %s", json.dumps(launches))


def _timed_iter(timer: "StageTimer", name: str, it):
    """Attribute generator-side (host featurization) time to a stage, each
    item's span with the item's number."""
    it = iter(it)
    for number in itertools.count():
        with timer.stage(name, number):
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
