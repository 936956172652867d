"""Deprecated `m6anet-compute_norm_factors` shim (reference: m6anet/deprecated/compute_norm_factors.py)."""
from . import run


def main(args=None):
    run("m6anet-compute_norm_factors", "compute_norm_factors", args)
