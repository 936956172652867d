"""Deprecated `m6anet-train` shim (reference: m6anet/deprecated/train.py)."""
from . import run


def main(args=None):
    run("m6anet-train", "train", args)
