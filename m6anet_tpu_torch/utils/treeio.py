"""Reading flat-key ``.npz`` parameter files into nested trees.

Keys are '/'-joined paths; all-digit segments denote list indices.  The
converted pretrained weight files use this layout.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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


def load_tree(path: str):
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
