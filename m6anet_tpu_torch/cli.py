"""Single `m6anet_tpu_torch` console entry point with a subcommand registry
(reference: m6anet/__init__.py:11-30).  ``inference`` and ``train`` are
ported; the other subcommands follow ROADMAP.md."""
from __future__ import annotations

from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser


def main(argv=None):
    from . import __version__
    from .scripts import inference, train

    modules = {"inference": inference, "train": train}

    parser = ArgumentParser(prog="m6anet_tpu_torch", formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("-v", "--version", action="version", version=f"%(prog)s {__version__}")
    subparsers = parser.add_subparsers(
        title="subcommands", description="valid commands", help="additional help", dest="command"
    )
    subparsers.required = True

    for name, mod in modules.items():
        p = subparsers.add_parser(name, parents=[mod.argparser()])
        p.set_defaults(func=mod.main)

    args = parser.parse_args(argv)
    args.func(args)
