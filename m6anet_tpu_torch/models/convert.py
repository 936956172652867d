"""Carry weights and optimizer state across, both ways: JAX parameter trees
and reference ``.pt`` files <-> this package's ``state_dict``, and the optax
Adam chain's state <-> ``torch.optim.Adam``'s.

The JAX package keeps parameters as a nested tree ``{"block<i>": {...}}``
of dicts and lists, with linear weights stored ``(in, out)``.  Here block
``i`` is ``blocks.<i>`` of :class:`~m6anet_tpu_torch.models.mil.MILModel`,
and the modules below it carry the tree's keys as names (list entries by
index), so a tree path maps onto a parameter name by its leaf alone: every
``w``/``b`` pair is an ``nn.Linear`` called ``linear`` (``(out, in)``,
PyTorch's layout), an ``embedding`` an ``nn.Embedding`` and the ``bn_*``
leaves an ``nn.BatchNorm1d`` called ``bn``.  For example
``block4/attention_v/layers/0/w`` is ``blocks.4.attention_v.layers.0.linear.weight``
transposed, and ``block3/bn_mean`` is ``blocks.3.bn.running_mean``.

The JAX training chain (clip -> decayed weights -> Adam -> scale) keeps
three kinds of leaves, in tree order: ``count`` (int32), then Adam's first
moments ``mu`` and second moments ``nu``, each over the parameter tree's
leaves in its flatten order (:func:`jax_leaf_order`).  They are torch
Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``.  JAX keeps moments for the
BatchNorm running statistics too; they never reach the parameters (the
train step overwrites those leaves), so they are dropped on import and
written as zeros on export.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.treeio import flatten_tree, unflatten_tree

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


_PORT_TO_LEAF = {key: (leaf, transpose) for leaf, (key, transpose) in _LEAF_MAP.items()}


def _port_key(path: str) -> Tuple[str, bool]:
    """``"block4/layers/0/w"`` -> ``("blocks.4.layers.0.linear.weight",
    True)``: the parameter name and whether the array is transposed."""
    block, *middle, leaf = path.split("/")
    if not block.startswith("block") or leaf not in _LEAF_MAP:
        raise ValueError(f"unknown parameter {path}")
    sub, transpose = _LEAF_MAP[leaf]
    return ".".join(["blocks", block.removeprefix("block"), *middle, sub]), transpose


def _jax_path(name: str) -> Optional[str]:
    """The inverse of :func:`_port_key`; None for a state_dict entry with no
    JAX leaf (``num_batches_tracked``)."""
    parts = name.split(".")
    sub = ".".join(parts[-2:])
    if sub == "bn.num_batches_tracked":
        return None
    if parts[0] != "blocks" or sub not in _PORT_TO_LEAF:
        raise ValueError(f"parameter {name} has no JAX leaf")
    return "/".join([f"block{parts[1]}", *parts[2:-2], _PORT_TO_LEAF[sub][0]])


def _transposed(path: str) -> bool:
    return _LEAF_MAP[path.rsplit("/", 1)[-1]][1]


def params_to_jax(state_dict: Dict[str, torch.Tensor]):
    """The inverse of :func:`params_from_jax`: the port's state_dict as a
    JAX parameter tree of numpy arrays (``num_batches_tracked`` has no JAX
    leaf and is dropped)."""
    flat = {}
    for name, value in state_dict.items():
        path = _jax_path(name)
        if path is None:
            continue
        arr = value.detach().cpu().numpy().astype(np.float32)
        flat[path] = np.ascontiguousarray(arr.T if _transposed(path) else arr)
    return unflatten_tree(flat)


def _flatten_order(path: str):
    # dict keys sorted as strings, list entries by index
    return [(0, int(part), "") if part.isdigit() else (1, 0, part) for part in path.split("/")]


def jax_leaf_order(model: torch.nn.Module) -> List[Tuple[str, str]]:
    """``(JAX tree path, port key)`` for every leaf of the model's JAX
    parameter tree, in the order ``jax.tree_util`` flattens it: dict keys
    sorted, list entries in index order (``layers/2`` before
    ``layers/10``)."""
    leaves = [(path, name) for name in model.state_dict() if (path := _jax_path(name)) is not None]
    return sorted(leaves, key=lambda leaf: _flatten_order(leaf[0]))


def adam_state_to_jax(model: torch.nn.Module, optimizer: torch.optim.Adam) -> List[np.ndarray]:
    """The optax chain's state leaves (``count``, ``mu``..., ``nu``...) for
    ``optimizer``'s state over ``model``; a parameter without state yet (no
    step taken) and every BatchNorm running statistic get zeros."""
    params = dict(model.named_parameters())
    shapes = {key: tuple(value.shape) for key, value in model.state_dict().items()}
    count = 0
    mu: List[np.ndarray] = []
    nu: List[np.ndarray] = []
    for path, key in jax_leaf_order(model):
        transpose = _transposed(path)
        state = optimizer.state.get(params[key], {}) if key in params else {}
        if state:
            count = int(state["step"])
        for out, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            if name in state:
                arr = state[name].detach().cpu().numpy()
                out.append(np.ascontiguousarray(arr.T if transpose else arr))
            else:
                out.append(np.zeros(shapes[key][::-1] if transpose else shapes[key], np.float32))
    return [np.asarray(count, np.int32), *mu, *nu]


def adam_state_from_jax(leaves: Sequence[np.ndarray], model: torch.nn.Module, optimizer: torch.optim.Adam) -> None:
    """Load the optax chain's state leaves into ``optimizer``'s state over
    ``model`` (the inverse of :func:`adam_state_to_jax`)."""
    order = jax_leaf_order(model)
    if len(leaves) != 1 + 2 * len(order):
        raise ValueError(
            f"expected {1 + 2 * len(order)} optimizer leaves (count, then mu and nu over "
            f"{len(order)} parameters), got {len(leaves)}"
        )
    params = dict(model.named_parameters())
    count = float(np.asarray(leaves[0]))
    mu, nu = leaves[1 : 1 + len(order)], leaves[1 + len(order) :]
    optimizer.state.clear()
    for (path, key), m, v in zip(order, mu, nu):
        if key not in params:  # a BatchNorm running statistic
            continue
        param = params[key]
        transpose = _transposed(path)

        def moment(arr):
            arr = np.asarray(arr, np.float32)
            return torch.tensor(arr.T if transpose else arr, device=param.device)

        optimizer.state[param] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": moment(m),
            "exp_avg_sq": moment(v),
        }


def params_from_jax(tree) -> "OrderedDict[str, torch.Tensor]":
    """Map a JAX parameter tree (numpy leaves, nested dicts and lists) onto
    the port's state_dict, blocks in index order."""
    flat = flatten_tree(tree)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path in sorted(flat, key=lambda p: int(p.split("/", 1)[0].removeprefix("block"))):
        key, transpose = _port_key(path)
        arr = np.asarray(flat[path], np.float32)
        sd[key] = torch.from_numpy(np.array(arr.T if transpose else arr))
        if path.endswith("/bn_mean"):
            sd[key.removesuffix("running_mean") + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
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
