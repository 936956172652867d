"""`m6anet_tpu_torch compute_norm_factors` — per-kmer normalization factors
from a labelled Train split (reference: m6anet/scripts/compute_norm_factors.py).

Writes ``norm_dict_nanopolish.npz`` and then a reference-compatible
``norm_dict_nanopolish.joblib``, as the JAX package's command does; the
second needs ``joblib`` and raises ``ImportError`` without it.
"""
from __future__ import annotations

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser


def argparser():
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("--input_dir", default=None,
                        help="directory containing data.info.labelled and data.json.")
    parser.add_argument("--out_dir", default=None, help="output directory.")
    parser.add_argument("--n_processes", default=1, type=int,
                        help="compatibility no-op (single sequential scan).")
    return parser


def main(args):
    import pandas as pd

    from ..data.norm import annotate_kmer_information, compute_norm_dict, save_norm_factors

    data_fpath = os.path.join(args.input_dir, "data.json")
    info_df = pd.read_csv(os.path.join(args.input_dir, "data.info.labelled"))
    info_df = info_df[info_df["set_type"] == "Train"].copy()
    info_df["transcript_position"] = info_df["transcript_position"].astype("int")
    info_df = annotate_kmer_information(data_fpath, info_df, args.n_processes)

    os.makedirs(args.out_dir, exist_ok=True)
    norm_dict = compute_norm_dict(data_fpath, info_df, args.n_processes)
    save_norm_factors(norm_dict, os.path.join(args.out_dir, "norm_dict_nanopolish.npz"))
    save_norm_factors(norm_dict, os.path.join(args.out_dir, "norm_dict_nanopolish.joblib"))
