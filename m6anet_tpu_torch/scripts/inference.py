"""`m6anet_tpu_torch inference` — site/read modification probability calling.

The flags of the JAX package's ``inference`` command (reference:
m6anet/scripts/inference.py), with ``--device {cuda,cpu}`` (default cuda),
``--backend {auto,torch,cuda_fused,cuda}`` and ``--precision
{auto,f32,f32x3,bf16}``.
``--site_proba_method mc`` samples the site probability over
``--num_iterations`` iterations drawn from ``--seed``.  ``--columnar`` reads
the columnar site store (several ``--input_dir`` are replicates, as for
data.json), ``--concat_shards`` joins several dataprep shards into one
dataset, ``--host_shard HOST_ID N_HOSTS`` scores one contiguous slice of the
sites into ``*.csv.shard<HOST_ID>`` files, and ``--distributed`` does that
for every rank of a ``torch.distributed`` job (``torchrun --nproc_per_node N
-m m6anet_tpu_torch inference ... --distributed``), after which rank 0
merges the shards.  --batch_size and --save_per_batch, the reference's own
flags, are accepted for compatibility and do nothing: batching is
capacity-based and results are always flushed.
"""
from __future__ import annotations

import json
import pathlib
import warnings
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

from ..constants import (
    DEFAULT_MIN_READS,
    DEFAULT_MODEL_CONFIG,
    DEFAULT_NORM_PATH,
    DEFAULT_PRETRAINED_MODEL,
    DEFAULT_PRETRAINED_MODELS,
    DEFAULT_READ_THRESHOLD,
    PRETRAINED_CONFIGS,
)
from ..data.batching import DEFAULT_READ_CAPACITY, DEFAULT_SITE_CAPACITY
from ..inference.engine import BACKENDS, METHODS, PRECISIONS

# default batch capacities (reads, sites) per device type: big batches on the
# card amortize each step's launch and copies
DEFAULT_CAPACITIES = {
    "cuda": (1048576, 16384),
    "cpu": (DEFAULT_READ_CAPACITY, DEFAULT_SITE_CAPACITY),
}


def argparser():
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("--input_dir", nargs="+", required=True,
                        help="dataprep output directories: data.info and data.json, "
                             "or the columnar store (columnar/, with --columnar). "
                             "Several are replicates, or with --concat_shards "
                             "disjoint shards of one dataset.")
    parser.add_argument("--out_dir", required=True,
                        help="directory to output inference results.")
    parser.add_argument("--pretrained_model", default=DEFAULT_PRETRAINED_MODEL, type=str,
                        help=f"pre-trained model. Options include {DEFAULT_PRETRAINED_MODELS}.")
    parser.add_argument("--model_config", default=DEFAULT_MODEL_CONFIG,
                        help="path to model config file (any TOML of the "
                             "reference's blocks whose pooling filter has a "
                             "per-read probability layer).")
    parser.add_argument("--model_state_dict", default=None,
                        help="path to model weights (.npz in the JAX package's "
                             "tree layout, or the reference's .pt of the "
                             "production model).")
    parser.add_argument("--norm_path", default=DEFAULT_NORM_PATH,
                        help="path to normalization factors file (.npz or reference .joblib).")
    parser.add_argument("--batch_size", default=16, type=int,
                        help="compatibility no-op (batching is capacity based).")
    parser.add_argument("--save_per_batch", default=2, type=int,
                        help="compatibility no-op (results are always flushed).")
    parser.add_argument("--n_processes", default=25, type=int,
                        help="host threads parsing data.json payloads (the native "
                             "parser releases the GIL; columnar input ignores this "
                             "— its feed is parse-free).")
    parser.add_argument("--num_iterations", default=1000, type=int,
                        help="number of sampling iterations (mc mode only).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to run on; 'cuda' fails when no card is "
                             "usable instead of falling back to the CPU.")
    parser.add_argument("--seed", default=0, type=int, help="random seed for mc sampling.")
    parser.add_argument("--read_proba_threshold", default=DEFAULT_READ_THRESHOLD, type=float,
                        help="probability threshold for a read to be considered modified.")
    parser.add_argument("--site_proba_method", default="exact", choices=METHODS,
                        help="exact = closed-form noisy-OR expectation; mc = "
                             "emulation of the reference's sampling estimator.")
    parser.add_argument("--read_capacity", default=None, type=int,
                        help="reads per device batch (static shape); default "
                             "1048576 on cuda, 65536 on cpu.")
    parser.add_argument("--site_capacity", default=None, type=int,
                        help="sites per device batch (static shape); default "
                             "16384 on cuda, 1024 on cpu.")
    parser.add_argument("--min_reads", default=DEFAULT_MIN_READS, type=int,
                        help="minimum reads for a site to be scored.")
    parser.add_argument("--backend", default="auto", choices=BACKENDS,
                        help="auto = the fused CUDA kernel on cuda for the "
                             "production architecture (m6anet.toml, all four "
                             "released models), the torch modules for any other "
                             "--model_config and on cpu; cuda = the encoder "
                             "kernel alone, site statistics in plain PyTorch; "
                             "cuda_fused and cuda take the production "
                             "architecture only.")
    parser.add_argument("--precision", default="auto", choices=PRECISIONS,
                        help="auto = f32x3 on the CUDA backends, f32 on "
                             "--backend torch; f32 = parity mode (f32 "
                             "CUDA-core arithmetic, TF32 off); f32x3 = layer 1 "
                             "in f32, layer 2 (on the tensor cores) and the head "
                             "as 3-pass bf16x3 products, ~f32-accurate (within the "
                             "1e-5 per-read golden tolerance); bf16 = fast "
                             "mode (~1e-3 probability error). f32x3/bf16 need "
                             "a CUDA backend.")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="continue an interrupted run from the last "
                             "fully-written site.")
    parser.add_argument("--skip_indiv_proba", default=False, action="store_true",
                        help="write only data.site_proba.csv (per-read "
                             "probabilities never leave the device).")
    parser.add_argument("--columnar", default=False, action="store_true",
                        help="read the columnar site store instead of data.json "
                             "(requires dataprep --format columnar or both).")
    parser.add_argument("--concat_shards", default=False, action="store_true",
                        help="treat multiple --input_dir directories as disjoint "
                             "dataprep shards (one logical dataset, one shared "
                             "--norm_path) instead of replicates.")
    parser.add_argument("--distributed", default=False, action="store_true",
                        help="multi-process mode: join the torch.distributed job "
                             "of the launcher's environment (torchrun), shard the "
                             "site index by rank, write per-rank CSV shards; rank 0 "
                             "merges them once every rank has finished.")
    parser.add_argument("--host_shard", nargs=2, type=int, default=None,
                        metavar=("HOST_ID", "N_HOSTS"),
                        help="manual host shard (alternative to --distributed): "
                             "score slice HOST_ID of N_HOSTS into *.csv.shard<HOST_ID>.")
    return parser


def main(args):
    from ..inference.engine import merge_host_shards, resolve_device
    from ..parallel.group import note_one_card
    from ..utils.logging import get_logger

    log = get_logger("m6anet_tpu_torch.inference")
    device = resolve_device(args.device)  # fails here, before any work, without a card
    if not args.distributed:
        note_one_card(device, log, "--distributed")
        host_shard = tuple(args.host_shard) if args.host_shard else None
        _score(args, device, host_shard)
        return

    from ..parallel.group import start_job

    job = start_job(device, device_collectives=False, log=log)
    failure = None
    try:
        _score(args, job.device, (job.rank, job.world_size))
    except Exception as e:  # reported to every rank below, then raised
        failure = e
    # every rank reports through the job's store, then rank 0 merges: only
    # after every rank has finished, however late, and never over a failed
    # rank's shard; rank 0's outcome reaches every rank the same way
    job.publish(f"inference/status/{job.rank}", "" if failure is None else f"{type(failure).__name__}: {failure}")
    if job.rank == 0:
        reports = job.wait_for([f"inference/status/{rank}" for rank in range(job.world_size)])
        failed = {rank: msg for rank, msg in enumerate(reports) if msg}
        if not failed:
            try:
                merge_host_shards(args.out_dir, job.world_size, write_indiv=not args.skip_indiv_proba)
            except Exception as e:  # reported to every rank below, then raised
                failure = e
                failed = {0: f"merging the shards: {type(e).__name__}: {e}"}
        job.publish("inference/failed", json.dumps(failed))
    else:
        failed = {int(rank): msg for rank, msg in json.loads(job.wait_for(["inference/failed"])[0]).items()}
    job.barrier()  # the store's host (rank 0 without torchrun's agent) stays until every rank has read it
    job.close()
    if failure is not None:
        raise failure
    if failed:
        raise RuntimeError(f"--distributed: rank(s) failed, the CSV shards were not merged: {failed}")


def _score(args, device, host_shard):
    """Load the model and the dataset the flags name, and run inference
    over them (over ``host_shard``'s slice of the sites, when given)."""
    import tomllib

    from ..data.dataset import build_dataset
    from ..inference.engine import run_inference
    from ..models.mil import load_model

    if args.model_state_dict is not None:
        warnings.warn("--model_state_dict is specified, overwriting default model weights")
        norm_path = args.norm_path
        threshold = args.read_proba_threshold
    else:
        if args.pretrained_model not in PRETRAINED_CONFIGS:
            raise ValueError(
                f"Invalid pretrained model {args.pretrained_model}, must be one of {DEFAULT_PRETRAINED_MODELS}"
            )
        args.model_state_dict, threshold, norm_path = PRETRAINED_CONFIGS[args.pretrained_model]

    with open(args.model_config, "rb") as f:
        model_config = tomllib.load(f)
    model = load_model(model_config, args.model_state_dict)

    pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)

    input_dir = args.input_dir
    root_dir = input_dir[0] if len(input_dir) == 1 else list(input_dir)
    if args.concat_shards:
        from ..data.dataset import ConcatSiteDataset

        dataset = ConcatSiteDataset(
            list(input_dir), columnar=args.columnar,
            min_reads=args.min_reads, norm_path=norm_path, mode="Inference",
        )
    elif args.columnar:
        if isinstance(root_dir, str):
            from ..data.columnar import ColumnarSiteDataset

            dataset = ColumnarSiteDataset(root_dir, min_reads=args.min_reads, norm_path=norm_path)
        else:  # multiple input dirs = replicates, like the data.json path
            from ..data.columnar import ReplicateColumnarDataset

            dataset = ReplicateColumnarDataset(root_dir, min_reads=args.min_reads, norm_path=norm_path)
    else:
        dataset = build_dataset(
            root_dir, min_reads=args.min_reads, norm_path=norm_path, mode="Inference"
        )

    read_cap, site_cap = DEFAULT_CAPACITIES[device.type]
    run_inference(
        model,
        dataset,
        args.out_dir,
        read_proba_threshold=threshold,
        method=args.site_proba_method,
        num_iterations=args.num_iterations,
        seed=args.seed,
        read_capacity=args.read_capacity or read_cap,
        site_capacity=args.site_capacity or site_cap,
        backend=args.backend,
        precision=args.precision,
        resume=args.resume,
        host_shard=host_shard,
        n_threads=args.n_processes,
        write_indiv=not args.skip_indiv_proba,
        device=device,
    )
