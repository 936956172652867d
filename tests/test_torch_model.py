"""The port's production model against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
per-read probabilities must agree to 1e-6 for every released weight set
(f32 on both sides, TF32 not involved on the CPU)."""
import os
import tomllib

import jax  # noqa: F401  (jax before torch, see conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m6anet_tpu import constants as jax_constants
from m6anet_tpu.models import load_model as jax_load_model
from m6anet_tpu.utils.treeio import load_tree
from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, PRETRAINED_CONFIGS
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.models.convert import load_weights, params_from_jax
from m6anet_tpu_torch.models.mil import MILModel

ASSETS = os.path.join(os.path.dirname(__file__), "data", "reference_assets")
REFERENCE_PT = {
    "HCT116_RNA002": "rna002_hct116.pt",
    "arabidopsis_RNA002": "rna002_arabidopsis_virc.pt",
    "HEK293T_RNA004": "rna004_hek293t_glori.pt",
    "HEK293T_RNA004_M6ACE": "rna004_hek293t_m6ace.pt",
}


def _config():
    with open(DEFAULT_MODEL_CONFIG, "rb") as f:
        return tomllib.load(f)


def _inputs(n=2048, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(n, 3)).astype(np.int32)
    return X, K


@pytest.mark.parametrize("name", sorted(PRETRAINED_CONFIGS))
def test_per_read_probability_matches_jax(name):
    X, K = _inputs()
    jax_model, jax_params = jax_load_model(_config(), jax_constants.PRETRAINED_CONFIGS[name][0])
    want = np.asarray(jax_model.per_read_probability(jax_params, {"X": jnp.asarray(X), "kmer": jnp.asarray(K)}))

    model = load_model(_config(), PRETRAINED_CONFIGS[name][0])
    with torch.no_grad():
        got = model.per_read_probability(
            {"X": torch.from_numpy(X), "kmer": torch.from_numpy(K.astype(np.int8))}
        ).numpy()
    assert got.shape == want.shape == (len(X),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_site_probability_on_fixed_blocks_matches_jax():
    """MILModel.forward: noisy-OR over blocks of n_reads_per_site (20) reads."""
    X, K = _inputs(n=32 * 20, seed=9)
    jax_model, jax_params = jax_load_model(_config(), jax_constants.DEFAULT_MODEL_WEIGHTS)
    want, _ = jax_model.forward(jax_params, {"X": jnp.asarray(X), "kmer": jnp.asarray(K)})
    model = load_model(_config(), PRETRAINED_CONFIGS["HCT116_RNA002"][0])
    with torch.no_grad():
        got = model({"X": torch.from_numpy(X), "kmer": torch.from_numpy(K)}).numpy()
    assert got.shape == (32,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(REFERENCE_PT))
def test_npz_and_reference_pt_give_the_same_state_dict(name):
    from_npz = params_from_jax(load_tree(PRETRAINED_CONFIGS[name][0]))
    from_pt = load_weights(os.path.join(ASSETS, REFERENCE_PT[name]))
    assert list(from_npz) == list(from_pt)
    for key in from_npz:
        torch.testing.assert_close(from_npz[key], from_pt[key], rtol=0, atol=0, msg=key)
    # and it loads into the production model with no missing or extra keys
    MILModel(_config()).load_state_dict(from_npz, strict=True)


def test_unported_block_type_names_the_roadmap_item():
    """Every block of the reference is ported now: another pooling filter
    builds, and an unknown block type raises naming the blocks there are."""
    cfg = _config()
    cfg["block"] = [dict(b) for b in cfg["block"]]
    cfg["block"][-1]["block_type"] = "SigmoidMeanPooling"
    assert type(MILModel(cfg).pooling).__name__ == "SigmoidMeanPooling"
    cfg["block"][-1]["block_type"] = "NoSuchPooling"
    with pytest.raises(ValueError, match="Unknown block_type 'NoSuchPooling'; available: .*SigmoidMeanPooling"):
        MILModel(cfg)
