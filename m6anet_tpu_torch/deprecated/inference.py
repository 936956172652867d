"""Deprecated `m6anet-run_inference` shim (reference: m6anet/deprecated/inference.py)."""
from . import run


def main(args=None):
    run("m6anet-run_inference", "inference", args)
