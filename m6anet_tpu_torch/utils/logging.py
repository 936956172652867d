"""Structured logging (the reference has only bare prints — SURVEY.md §5)."""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_configured = False


def get_logger(name: str = "m6anet_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("M6ANET_TPU_LOGLEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("m6anet_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
