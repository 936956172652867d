"""Full training-state checkpointing (parameters + Adam state + epoch), in
the JAX package's layout, so a checkpoint crosses between the packages:

  model_states.npz   parameter tree (flat keys, see utils/treeio.py; linear
                     weights stored (in, out), as the JAX package keeps them)
  opt_state.npz      the optax chain's state leaves in tree-flatten order
                     (``leaf_0000`` = Adam's count, then its moments; see
                     models/convert.py)
  meta.json          epoch + leaf count
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..models.convert import adam_state_from_jax, adam_state_to_jax, params_from_jax, params_to_jax
from ..utils.treeio import load_tree, save_tree


def save_checkpoint(path: str, model, optimizer, epoch: int) -> None:
    os.makedirs(path, exist_ok=True)
    save_tree(os.path.join(path, "model_states.npz"), params_to_jax(model.state_dict()))
    leaves = adam_state_to_jax(model, optimizer)
    np.savez(
        os.path.join(path, "opt_state.npz"),
        **{f"leaf_{i:04d}": leaf for i, leaf in enumerate(leaves)},
    )
    with open(os.path.join(path, "meta.json"), "w", encoding="utf-8") as f:
        json.dump({"epoch": epoch, "n_leaves": len(leaves)}, f)


def restore_checkpoint(path: str, model, optimizer) -> int:
    """Load a checkpoint (written by either package) into ``model`` and
    ``optimizer``, in place; returns its epoch."""
    model.load_state_dict(params_from_jax(load_tree(os.path.join(path, "model_states.npz"))))
    with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "opt_state.npz")) as data:
        leaves = [data[f"leaf_{i:04d}"] for i in range(meta["n_leaves"])]
    adam_state_from_jax(leaves, model, optimizer)
    return meta["epoch"]


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Most recent epoch directory under save_dir/model_states, if any."""
    root = os.path.join(save_dir, "model_states")
    if not os.path.isdir(root):
        return None
    epochs = [int(d) for d in os.listdir(root) if d.isdigit()]
    if not epochs:
        return None
    return os.path.join(root, str(max(epochs)))
