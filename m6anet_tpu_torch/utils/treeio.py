"""Flat-key ``.npz`` serialization of parameter trees (dicts / lists of
arrays), the JAX package's layout.

Keys are '/'-joined paths; all-digit segments denote list indices.  The
converted pretrained weight files and the training checkpoints use this
layout, so both packages read what either writes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
        return out
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)

    def normalize(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [normalize(node[str(i)]) for i in range(len(node))]
        return {k: normalize(v) for k, v in node.items()}

    return normalize(root)


def save_tree(path: str, tree) -> None:
    np.savez(path, **flatten_tree(tree))


def load_tree(path: str):
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
