"""Single `m6anet_tpu_torch` console entry point with a subcommand registry
(reference: m6anet/__init__.py:11-30), in the JAX package's order."""
from __future__ import annotations

from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

MODULES = ["dataprep", "inference", "train", "compute_norm_factors", "convert"]


def main(argv=None):
    import importlib

    from . import __version__

    parser = ArgumentParser(prog="m6anet_tpu_torch", formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("-v", "--version", action="version", version=f"%(prog)s {__version__}")
    subparsers = parser.add_subparsers(
        title="subcommands", description="valid commands", help="additional help", dest="command"
    )
    subparsers.required = True

    for name in MODULES:
        mod = importlib.import_module(f".scripts.{name}", __package__)
        p = subparsers.add_parser(name, parents=[mod.argparser()])
        p.set_defaults(func=mod.main)

    args = parser.parse_args(argv)
    args.func(args)
