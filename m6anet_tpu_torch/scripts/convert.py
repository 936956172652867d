"""`m6anet_tpu_torch convert` — merge an old dataprep's data.index and
data.readcount into data.info (reference: m6anet/scripts/convert.py).  It
converts no weights."""
from __future__ import annotations

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser


def argparser():
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("--input_dir", required=True,
                        help="directory containing data.readcount and data.index.")
    parser.add_argument("--out_dir", required=True, help="directory to output data.info.")
    return parser


def main(args):
    import pandas as pd

    os.makedirs(args.out_dir, exist_ok=True)
    data_index = pd.read_csv(os.path.join(args.input_dir, "data.index"))
    data_readcount = pd.read_csv(os.path.join(args.input_dir, "data.readcount"))
    data_info = data_readcount.merge(data_index, on=["transcript_id", "transcript_position"])
    data_info.to_csv(os.path.join(args.out_dir, "data.info"), index=False)
