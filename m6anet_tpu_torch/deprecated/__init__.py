"""Legacy per-command entry points (reference: m6anet/deprecated/*), kept
alive with a DeprecationWarning that names the port's subcommand."""
from __future__ import annotations

import importlib
import warnings


def run(old_name: str, subcommand: str, args=None) -> None:
    """Warn that ``old_name`` is deprecated, then run ``m6anet_tpu_torch
    <subcommand>`` with ``args`` (parsed from the command line when None)."""
    warnings.warn(
        f"{old_name} is deprecated and will be removed in a future version; "
        f"use `m6anet_tpu_torch {subcommand}` instead",
        DeprecationWarning,
    )
    script = importlib.import_module(f"..scripts.{subcommand}", __package__)
    if args is None:
        args = script.argparser().parse_args()
    script.main(args)
