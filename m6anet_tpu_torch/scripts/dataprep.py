"""`m6anet_tpu_torch dataprep` — featurize nanopolish/f5c eventalign.txt.

The flags of the JAX package's ``dataprep``, with the same defaults
(reference: m6anet/scripts/dataprep.py).  Host work only: numpy and the
native parser, no card.
"""
from __future__ import annotations

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

from ..constants import NUM_NEIGHBORING_FEATURES


def argparser():
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("--eventalign", required=True,
                        help="eventalign filepath, the output from nanopolish.")
    parser.add_argument("--out_dir", required=True, help="output directory.")
    parser.add_argument("--n_processes", default=1, type=int, help="number of processes to run.")
    parser.add_argument("--chunk_size", default=1_000_000, type=int,
                        help="compatibility no-op (the indexer streams).")
    parser.add_argument("--readcount_min", default=1, type=int, help="minimum read counts per gene.")
    parser.add_argument("--readcount_max", default=1000, type=int, help="maximum read counts per gene.")
    parser.add_argument("--min_segment_count", default=20, type=int,
                        help="minimum read counts per candidate segment.")
    parser.add_argument("--skip_index", default=False, action="store_true",
                        help="skip indexing eventalign.txt (reuse an existing eventalign.index).")
    parser.add_argument("--n_neighbors", default=NUM_NEIGHBORING_FEATURES, type=int,
                        help="number of neighboring features to extract.")
    parser.add_argument("--compress", default=False, action="store_true",
                        help="round features to 3 decimals in data.json.")
    parser.add_argument("--host_shard", nargs=2, type=int, default=None,
                        metavar=("HOST_ID", "N_HOSTS"),
                        help="featurize only this host's transcript slice "
                             "(multi-host dataprep; combine results with "
                             "inference --concat_shards).")
    parser.add_argument("--format", dest="output_format", default="json",
                        choices=["json", "columnar", "both"],
                        help="site-store format: reference-compatible data.json, "
                             "memory-mappable columnar store, or both.")
    return parser


def main(args):
    from ..dataprep.runner import run_dataprep

    os.makedirs(args.out_dir, exist_ok=True)
    run_dataprep(
        args.eventalign,
        args.out_dir,
        n_processes=args.n_processes,
        chunk_size=args.chunk_size,
        readcount_min=args.readcount_min,
        readcount_max=args.readcount_max,
        min_segment_count=args.min_segment_count,
        n_neighbors=args.n_neighbors,
        compress=args.compress,
        skip_index=args.skip_index,
        output_format=args.output_format,
        host_shard=tuple(args.host_shard) if args.host_shard else None,
    )
