"""Deprecated `m6anet-dataprep` shim (reference: m6anet/deprecated/dataprep.py)."""
from . import run


def main(args=None):
    run("m6anet-dataprep", "dataprep", args)
