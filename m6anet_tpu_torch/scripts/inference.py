"""`m6anet_tpu_torch inference` — site/read modification probability calling.

The flags of the JAX package's ``inference`` command (reference:
m6anet/scripts/inference.py), with ``--device {cuda,cpu}`` (default cuda),
``--backend {auto,torch,cuda_fused,cuda}`` and ``--precision {auto,f32}``.
``--site_proba_method mc`` samples the site probability over
``--num_iterations`` iterations drawn from ``--seed``.  Flags whose path is
not ported yet stop the parse with the ROADMAP.md item that will bring it.
--batch_size and --save_per_batch, the reference's own flags, are accepted
for compatibility and do nothing: batching is capacity-based and results
are always flushed.
"""
from __future__ import annotations

import argparse
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


class _NotPorted(argparse.Action):
    """Stop the parse: this flag's path waits for a ROADMAP.md item."""

    def __init__(self, option_strings, dest, roadmap_item, **kwargs):
        self.roadmap_item = roadmap_item
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(
            f"{option_string} is not ported to m6anet_tpu_torch yet "
            f"(ROADMAP.md, Queue 1 '{self.roadmap_item}')"
        )


def argparser():
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("--input_dir", nargs="+", required=True,
                        help="directories containing data.info and data.json.")
    parser.add_argument("--out_dir", required=True,
                        help="directory to output inference results.")
    parser.add_argument("--pretrained_model", default=DEFAULT_PRETRAINED_MODEL, type=str,
                        help=f"pre-trained model. Options include {DEFAULT_PRETRAINED_MODELS}.")
    parser.add_argument("--model_config", default=DEFAULT_MODEL_CONFIG,
                        help="path to model config file.")
    parser.add_argument("--model_state_dict", default=None,
                        help="path to model weights (.npz native, or a reference .pt).")
    parser.add_argument("--norm_path", default=DEFAULT_NORM_PATH,
                        help="path to normalization factors file (.npz or reference .joblib).")
    parser.add_argument("--batch_size", default=16, type=int,
                        help="compatibility no-op (batching is capacity based).")
    parser.add_argument("--save_per_batch", default=2, type=int,
                        help="compatibility no-op (results are always flushed).")
    parser.add_argument("--n_processes", default=25, type=int,
                        help="host threads parsing data.json payloads (the native "
                             "parser releases the GIL).")
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
                        help="auto = the fused CUDA kernel on cuda, the torch "
                             "modules on cpu; cuda = the encoder kernel alone, "
                             "site statistics in plain PyTorch; other "
                             "architectures run on cuda only with an explicit "
                             "--backend torch.")
    parser.add_argument("--precision", default="auto", choices=PRECISIONS,
                        help="auto = f32 (parity mode; TF32 off).")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="continue an interrupted run from the last "
                             "fully-written site.")
    parser.add_argument("--skip_indiv_proba", default=False, action="store_true",
                        help="write only data.site_proba.csv (per-read "
                             "probabilities never leave the device).")
    parser.add_argument("--columnar", nargs=0, action=_NotPorted,
                        roadmap_item="Columnar store and concatenated shards",
                        help="not ported yet.")
    parser.add_argument("--concat_shards", nargs=0, action=_NotPorted,
                        roadmap_item="Columnar store and concatenated shards",
                        help="not ported yet.")
    parser.add_argument("--distributed", nargs=0, action=_NotPorted,
                        roadmap_item="Multi-device runs", help="not ported yet.")
    parser.add_argument("--host_shard", nargs=2, action=_NotPorted,
                        roadmap_item="Multi-device runs", metavar=("HOST_ID", "N_HOSTS"),
                        help="not ported yet.")
    return parser


def main(args):
    import tomllib

    from ..data.dataset import build_dataset
    from ..inference.engine import resolve_device, run_inference
    from ..models.mil import load_model

    device = resolve_device(args.device)  # fails here, before any work, without a card

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
        n_threads=args.n_processes,
        write_indiv=not args.skip_indiv_proba,
        device=device,
    )
