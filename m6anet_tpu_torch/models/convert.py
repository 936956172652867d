"""Carry weights across: JAX parameter trees and reference ``.pt`` files ->
this package's ``state_dict``.

The JAX package keeps parameters as ``{"block<i>": {...}}`` with linear
weights stored ``(in, out)``; here block ``i`` is ``blocks.<i>`` of
:class:`~m6anet_tpu_torch.models.mil.MILModel`, every linear layer is
``.linear`` (``(out, in)``, PyTorch's layout) and every BatchNorm ``.bn``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

# JAX leaf name -> (port sub-key, transpose)
_LEAF_MAP = {
    "embedding": ("embedding.weight", False),
    "w": ("linear.weight", True),
    "b": ("linear.bias", False),
    "bn_scale": ("bn.weight", False),
    "bn_bias": ("bn.bias", False),
    "bn_mean": ("bn.running_mean", False),
    "bn_var": ("bn.running_var", False),
}


def params_from_jax(tree: Dict[str, Dict[str, np.ndarray]]) -> "OrderedDict[str, torch.Tensor]":
    """Map a JAX parameter tree (numpy leaves) onto the port's state_dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for block in sorted(tree, key=lambda k: int(k.removeprefix("block"))):
        index = int(block.removeprefix("block"))
        for leaf, value in tree[block].items():
            if leaf not in _LEAF_MAP:
                raise ValueError(f"unknown parameter {block}/{leaf}")
            key, transpose = _LEAF_MAP[leaf]
            arr = np.asarray(value, np.float32)
            sd[f"blocks.{index}.{key}"] = torch.from_numpy(np.ascontiguousarray(arr.T if transpose else arr))
        if "bn_mean" in tree[block]:
            sd[f"blocks.{index}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _tree_from_reference_pt(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The reference's production-model state_dict as a JAX-layout tree
    (the key map of the JAX package's ``scripts/inference.py:115-141``)."""
    sd = {k: v.numpy() for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}
    return {
        "block1": {"embedding": sd["read_level_encoder.1.embedding_layer.weight"]},
        "block3": {
            "w": sd["read_level_encoder.3.layers.0.weight"].T,
            "b": sd["read_level_encoder.3.layers.0.bias"],
            "bn_scale": sd["read_level_encoder.3.layers.1.weight"],
            "bn_bias": sd["read_level_encoder.3.layers.1.bias"],
            "bn_mean": sd["read_level_encoder.3.layers.1.running_mean"],
            "bn_var": sd["read_level_encoder.3.layers.1.running_var"],
        },
        "block4": {
            "w": sd["read_level_encoder.4.layers.0.weight"].T,
            "b": sd["read_level_encoder.4.layers.0.bias"],
        },
        "block5": {
            "w": sd["pooling_filter.probability_layer.0.weight"].T,
            "b": sd["pooling_filter.probability_layer.0.bias"],
        },
    }


def load_weights(path: str) -> "OrderedDict[str, torch.Tensor]":
    """Load ``.npz`` native weights or a reference ``.pt`` as a state_dict."""
    if path.endswith(".pt"):
        return params_from_jax(_tree_from_reference_pt(path))
    from ..utils.treeio import load_tree

    return params_from_jax(load_tree(path))
