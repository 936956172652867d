"""TOML helpers: stdlib tomllib for reading plus a minimal writer (no
``toml`` package is needed; train runs dump their config as train_info.toml
for reproducibility, reference: m6anet/scripts/train.py:87-89).  The port's
own copy of the JAX package's ``utils/config.py``."""
from __future__ import annotations

import tomllib
from typing import Any, Dict, List, Tuple


def load_toml(path: str) -> Dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    raise TypeError(f"cannot serialise {type(v)} to TOML")


def _dump_table(d: Dict, prefix: str, lines: List[str]) -> None:
    scalars: List[Tuple[str, Any]] = []
    tables: List[Tuple[str, Dict]] = []
    array_tables: List[Tuple[str, List[Dict]]] = []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v))
        elif isinstance(v, list) and v and all(isinstance(x, dict) for x in v):
            array_tables.append((k, v))
        else:
            scalars.append((k, v))
    for k, v in scalars:
        lines.append(f"{k} = {_fmt_value(v)}")
    for k, items in array_tables:
        name = f"{prefix}{k}"
        for item in items:
            lines.append(f"\n[[{name}]]")
            _dump_table(item, f"{name}.", lines)
    for k, v in tables:
        name = f"{prefix}{k}"
        lines.append(f"\n[{name}]")
        _dump_table(v, f"{name}.", lines)


def dumps_toml(d: Dict) -> str:
    lines: List[str] = []
    _dump_table(d, "", lines)
    return "\n".join(lines).lstrip("\n") + "\n"


def dump_toml(d: Dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps_toml(d))
