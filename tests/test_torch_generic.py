"""The generic model path of the port against the JAX package, on the CPU:
every block of the registry, weights and Adam state of nested parameter
trees carried both ways, configs without a pooling filter or without a
per-read layer, generic configs through ``run_inference`` and the CLIs, and
the train step of non-production architectures.

Inputs are made with numpy from a seed; the port takes the JAX ``init``
carried across by ``params_from_jax``.  Tolerances: block outputs and their
read-level methods 1e-6 (and 1e-6 relative: the KDE filters' outputs reach
a few units); gradients within 1e-5 of their leaf's largest entry, and
where the JAX package's own gradient is further than that from the exact
one (an f64 copy of the port's block: the attention softmax's
cancellations, up to 1.2e-5 of the leaf), within that distance more;
inference per read 1e-6, per site 1e-5, mod_ratio equal; a train step as
tests/test_torch_train.py holds the production model's (PERF.md,
"Training").
"""
import copy
import json
import os
import tomllib

import jax  # noqa: F401  (jax before torch, see conftest.py)
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from m6anet_tpu.constants import DEFAULT_NORM_PATH as JAX_NORM_PATH
from m6anet_tpu.constants import DEFAULT_READ_THRESHOLD
from m6anet_tpu.constants import asset_path as jax_asset_path
from m6anet_tpu.data.dataset import build_dataset as jax_build_dataset
from m6anet_tpu.inference.engine import run_inference as jax_run_inference
from m6anet_tpu.models.blocks import Linear as JaxLinear
from m6anet_tpu.models.mil import BLOCK_REGISTRY as JAX_REGISTRY
from m6anet_tpu.models.mil import MILModel as JaxMILModel
from m6anet_tpu.train import checkpoint as jax_checkpoint
from m6anet_tpu.train import loop as jax_loop
from m6anet_tpu.train import losses as jax_losses
from m6anet_tpu.utils.treeio import save_tree as jax_save_tree
from m6anet_tpu_torch.cli import main as port_main
from m6anet_tpu_torch.constants import (
    DEFAULT_MIN_READS,
    DEFAULT_MODEL_CONFIG,
    DEFAULT_NORM_PATH,
    PRETRAINED_CONFIGS,
    SIGNAL_MODEL_CONFIG,
    TRAIN_CONFIG_TEMPLATE,
)
from m6anet_tpu_torch.data.dataset import build_dataset
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.models.blocks import BN_EPS, BN_MOMENTUM, Linear
from m6anet_tpu_torch.models.convert import (
    adam_state_from_jax,
    adam_state_to_jax,
    jax_leaf_order,
    params_from_jax,
    params_to_jax,
)
from m6anet_tpu_torch.models.mil import BLOCK_REGISTRY, NO_PER_READ_LAYER, MILModel
from m6anet_tpu_torch.models.pooling import kde_centres
from m6anet_tpu_torch.train import loop, losses
from m6anet_tpu_torch.utils.config import dump_toml, load_toml
from m6anet_tpu_torch.utils.treeio import flatten_tree, load_tree

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
# the signal-only benchmark configuration, whose seeded laws give its
# BatchNorm statistics far from the identity
SIGNAL_BENCH_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench",
                                   "configs", "m6anet_signal.json")
KEYS_I = ["transcript_id", "transcript_position", "read_index"]
KEYS_S = ["transcript_id", "transcript_position"]
LR, WD, CLIP = 4e-3, 1e-5, 5.0
SITES = 3

# (block spec, input kind): "normal" features N(0, 1), "unit" features in
# [0, 1] (the KDE filters' domain), "dict" the aggregators' {"X", "kmer"}
# pass-through, "cube" a (4, 5, 6) tensor for Flatten
BLOCKS = {
    "SigmoidProdPooling": ({"input_channel": 8}, "normal"),
    "SigmoidMeanPooling": ({"input_channel": 8, "n_reads_per_site": 5}, "normal"),
    "SigmoidMaxPooling": ({"input_channel": 8}, "normal"),
    "SummaryStatsAggregator": ({"input_channel": 8}, "normal"),
    "SummaryStatsAggregator-dict": ({"input_channel": 8, "n_reads_per_site": 5}, "dict"),
    "MeanAggregator": ({"input_channel": 8}, "normal"),
    "MeanAggregator-dict": ({"input_channel": 8}, "dict"),
    "Attention": ({"input_channel": 8, "hidden_layers": [6, 2]}, "normal"),
    "GatedAttention": ({"input_channel": 8, "hidden_layers_1": [6, 5], "hidden_layers_2": [4, 2],
                        "activation": "tanh"}, "normal"),
    "KDELayer": ({"input_channel": 2, "n_bins": 25, "sigma": 0.1}, "unit"),
    "KDEAttentionLayer": ({"input_channel": 2, "hidden_layers": [4, 1], "n_bins": 7, "sigma": 0.15}, "unit"),
    "KDEGatedAttentionLayer": ({"input_channel": 2, "hidden_layers_1": [4], "hidden_layers_2": [3, 2],
                                "n_bins": 11, "sigma": 0.1}, "unit"),
    "ProbabilityAttention": ({"input_channel": 2, "hidden_layers_1": [4], "hidden_layers_2": [3, 1],
                              "n_bins": 13, "sigma": 0.1, "read_classifier": "max_pooling"}, "unit"),
    "SummaryStatsProbability": ({"input_channel": 8, "read_classifier": "mean_pooling"}, "normal"),
    "ExtractSignal": ({}, "dict"),
    "Flatten": ({"start_dim": 1, "end_dim": -1}, "cube"),
    "Flatten-leading": ({"start_dim": 0, "end_dim": 1}, "cube"),
}
METHODS = ("read_level_prob", "per_read_prob", "attention_weights")


def _block_pair(case, seed=0):
    spec, kind = BLOCKS[case]
    name = case.split("-")[0]
    jax_block = JAX_REGISTRY[name](**spec)
    params = jax_block.init(jax.random.PRNGKey(seed))
    model = MILModel({"block": [{"block_type": name, **spec}]})
    model.load_state_dict(params_from_jax({"block0": jax.tree.map(np.asarray, params)} if params else {}))
    return jax_block, params, model.blocks[0], kind


def _input(kind, spec, seed=1):
    rng = np.random.default_rng(seed)
    n = SITES * spec.get("n_reads_per_site", 20)
    if kind == "cube":
        return rng.normal(size=(4, 5, 6)).astype(np.float32)
    if kind == "dict":
        return {"X": rng.normal(size=(n, spec.get("input_channel", 9))).astype(np.float32),
                "kmer": rng.integers(0, 66, size=(n, 3)).astype(np.int32)}
    draw = rng.uniform(size=(n, spec["input_channel"])) if kind == "unit" else rng.normal(size=(n, spec["input_channel"]))
    return draw.astype(np.float32)


def _to_jax(x):
    return {k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict) else jnp.asarray(x)


def _to_torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict) else torch.from_numpy(x)


def _close(got, want, atol=1e-6, msg=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), msg
        for key in want:
            _close(got[key], want[key], atol, f"{msg}[{key}]")
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want), msg
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=atol, err_msg=msg)


# ------------------------------------------------------------ the registry
def test_registry_holds_the_reference_blocks():
    """The 18 blocks of tests/test_model.py's list: the JAX registry less
    its abstract bases, which no config can run."""
    expected = {
        "DeaggregateNanopolish", "ExtractSignal", "ConcatenateFeatures", "Flatten",
        "KmerMultipleEmbedding", "Linear",
        "SigmoidProdPooling", "SigmoidMeanPooling", "SigmoidMaxPooling",
        "SummaryStatsAggregator", "MeanAggregator", "Attention", "GatedAttention",
        "ProbabilityAttention", "SummaryStatsProbability",
        "KDELayer", "KDEAttentionLayer", "KDEGatedAttentionLayer",
    }
    assert set(BLOCK_REGISTRY) == expected
    assert set(JAX_REGISTRY) - expected == {"Block", "PoolingFilter", "InstanceBasedPooling"}
    with pytest.raises(ValueError, match="Invalid read classifier name"):
        BLOCK_REGISTRY["ProbabilityAttention"](2, [4], [3, 1], 4, 0.1, read_classifier="median_pooling")


@pytest.mark.parametrize("n_bins", [1, 2, 4, 7, 11, 13, 25, 50])
def test_kde_centres_are_jax_linspace_bit_for_bit(n_bins):
    assert np.array_equal(kde_centres(n_bins).numpy(), np.asarray(jnp.linspace(0.0, 1.0, n_bins)))


# ------------------------------------------------------------ each block
@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax(case):
    """Output, read-level methods and gradients of each block from the JAX
    init carried across, on seeded inputs."""
    jax_block, params, block, kind = _block_pair(case)
    spec = BLOCKS[case][0]
    x = _input(kind, spec)
    want, _ = jax_block.apply(params, _to_jax(x))
    with torch.no_grad():
        _close(block(_to_torch(x)), want, msg=case)
    for method in METHODS:
        assert hasattr(block, method) == hasattr(jax_block, method), (case, method)
        if hasattr(jax_block, method) and kind != "dict":
            with torch.no_grad():
                _close(getattr(block, method)(_to_torch(x)), getattr(jax_block, method)(params, jnp.asarray(x)),
                       msg=f"{case}.{method}")
    if kind == "dict":
        return

    # gradients of a seeded linear functional of the output, by the input
    # and every parameter; an f64 copy of the block gives the exact values
    weights = np.random.default_rng(2).normal(size=np.shape(want)).astype(np.float32)

    def objective(p, xj):
        return jnp.sum(jax_block.apply(p, xj)[0] * weights)

    jax_gp, jax_gx = jax.grad(objective, argnums=(0, 1))(params, jnp.asarray(x))
    want_grads = {"x": np.asarray(jax_gx), **(flatten_tree(jax.tree.map(np.asarray, jax_gp)) if params else {})}
    got_grads, exact_grads = (_port_grads(block.to(dtype), x, weights) for dtype in (torch.float32, torch.float64))
    assert sorted(got_grads) == sorted(want_grads)
    for key, g in want_grads.items():
        got = got_grads[key]
        if not g.any():  # a read classifier, which the output does not reach
            assert "read_classifier" in key and not got.any(), key
            continue
        if np.abs(g).max() < 1e-6:
            # the bias of an attention's last layer: the softmax over the
            # reads does not move when every logit shifts, so its gradient
            # is zero in exact arithmetic and f32 noise on both sides
            last = len(spec.get("hidden_layers", spec.get("hidden_layers_2", []))) - 1
            assert key.endswith(f"attention/layers/{last}/b") or key == f"layers/{last}/b", key
            assert np.abs(got).max() < 1e-6, key
            continue
        # within 1e-5 of the leaf's largest entry, and where the JAX package
        # is itself further than that from the exact gradient (a softmax's
        # cancellations), within its own distance more
        allowed = 1e-5 * np.abs(g).max() + np.abs(g - exact_grads[key])
        assert (np.abs(got - g) <= allowed).all(), (case, key, np.abs(got - g).max())


def _port_grads(block, x, weights):
    """Gradients of sum(block(x) * weights) by x and every parameter, in the
    JAX tree's layout (``"x"`` and the paths under the block), in the
    block's dtype; a parameter the output does not reach gets zeros, as
    under jax.grad."""
    dtype = next(block.parameters(), torch.empty(0)).dtype
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    (block(xt) * torch.from_numpy(weights).to(dtype)).sum().backward()
    grads = {f"blocks.0.{name}": torch.zeros_like(p) if p.grad is None else p.grad
             for name, p in block.named_parameters()}
    flat = {k.split("/", 1)[1]: v for k, v in flatten_tree(params_to_jax(grads)).items()} if grads else {}
    with torch.no_grad():
        block.zero_grad(set_to_none=True)
    return {"x": xt.grad.double().numpy(), **{k: v.astype(np.float64) for k, v in flat.items()}}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_params_round_trip_is_the_identity(case):
    """params_to_jax(params_from_jax(tree)) gives back every leaf, bit for
    bit, with the tree's dicts and lists where they were."""
    _, params, block, _ = _block_pair(case, seed=5)
    tree = {"block7": jax.tree.map(np.asarray, params)} if params else {}
    back = params_to_jax(params_from_jax(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


# ------------------------------------------ the Linear block's eval BatchNorm
def _bn_linear_params(case, rng):
    """The JAX parameters of a BatchNorm Linear block: drawn from the laws of
    the signal-only benchmark config's first block, the released
    HCT116_RNA002 model's block, or a running variance near 0 under a large
    BatchNorm scale."""
    if case == "signal_laws":
        with open(SIGNAL_BENCH_CONFIG) as f:
            laws = [w for w in json.load(f)["weights"]["seeded"] if w["leaf"].startswith("block2/")]
        return {w["leaf"].split("/")[1]: rng.uniform(w["low"], w["high"], size=w["shape"]).astype(np.float32)
                for w in laws}
    if case == "HCT116_RNA002":
        model = load_model(load_toml(DEFAULT_MODEL_CONFIG), PRETRAINED_CONFIGS[case][0])
        index = next(i for i, b in enumerate(model.blocks) if getattr(b, "bn", None) is not None)
        return params_to_jax(model.state_dict())[f"block{index}"]
    n_in, h1 = 9, 150
    bound = 1.0 / np.sqrt(n_in)
    draw = {"w": ((n_in, h1), -bound, bound), "b": ((h1,), -bound, bound), "bn_scale": ((h1,), 5.0, 10.0),
            "bn_bias": ((h1,), -1.0, 1.0), "bn_mean": ((h1,), -0.5, 0.5), "bn_var": ((h1,), 0.0, 1e-6)}
    return {k: rng.uniform(lo, hi, size=shape).astype(np.float32) for k, (shape, lo, hi) in draw.items()}


def _bn_linear(params):
    n_in, h1 = params["w"].shape
    spec = {"input_channel": n_in, "output_channel": h1, "activation": "relu", "batch_norm": True}
    model = MILModel({"block": [{"block_type": "Linear", **spec}]})
    model.load_state_dict(params_from_jax({"block0": params}))
    return JaxLinear(**spec), model.blocks[0]


@pytest.mark.parametrize("case", ["signal_laws", "HCT116_RNA002", "near_zero_variance"])
def test_eval_batch_norm_fold_matches_jax(case):
    """The eval forward of a BatchNorm Linear block (one GEMM on the weight
    and bias with the running statistics folded in) against the JAX block's
    formula, which normalises after its GEMM, at 1e-6.  With a running
    variance near 0 a unit's gain |scale| / sqrt(var + eps) reaches ~3,000,
    and both sides' f32 rounding of x w + b grows with it (~1e-3 against an
    f64 copy, on each side): there the outputs are compared in the units of
    x w + b, each unit's divided by its gain.  In every case the fold lies
    no further from the f64 copy than twice the JAX block does."""
    rng = np.random.default_rng(11)
    params = _bn_linear_params(case, rng)
    jax_block, block = _bn_linear(params)
    x = rng.normal(size=(1031, params["w"].shape[0])).astype(np.float32)
    want = np.asarray(jax_block.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))[0])
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
        exact = copy.deepcopy(block).double()(torch.from_numpy(x).double()).numpy()
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max(), case
    gain = np.abs(params["bn_scale"].astype(np.float64)) / np.sqrt(params["bn_var"].astype(np.float64) + BN_EPS)
    if case == "near_zero_variance":
        assert gain.max() > 1e3
        got, want = got / gain, want / gain
    _close(got, want, msg=case)


def test_eval_forward_reads_the_activations_once():
    """Under torch.profiler on the CPU, the only top-level op of a BatchNorm
    Linear block's eval forward that reads an (N, H1) tensor is the relu:
    the BatchNorm is in the GEMM's weight and bias.  In train mode its
    passes over the GEMM's output are still there."""
    block = Linear(9, 150)
    block.init(torch.Generator().manual_seed(0))
    x = torch.randn(257, 9, generator=torch.Generator().manual_seed(1))

    def top_level_ops(train):
        with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                                     record_shapes=True) as prof:
            block(x, train=train)
        top = [e for e in prof.events() if e.cpu_parent is None]
        return [e.name for e in top], [e.name for e in top if [257, 150] in e.input_shapes]

    ops, reads = top_level_ops(train=False)
    assert reads == ["aten::relu"] and ops.count("aten::linear") == 1, ops
    _, train_reads = top_level_ops(train=True)
    assert {"aten::sub", "aten::mul", "aten::add", "aten::relu"} <= set(train_reads), train_reads


class _TwoSameRanks:
    """A data-parallel group of two ranks that hold the same rows."""

    world_size = 2

    def all_reduce_sum(self, t):
        return t * 2

    def draw_rows(self, shape, generator, device):
        return torch.rand(shape, generator=generator, device=device)


def _unfolded_train_forward(block, x, generator):
    """The Linear block's train-mode forward as it was written before the
    eval fold: BatchNorm by the batch's statistics, the running statistics'
    update, relu, dropout."""
    y = block.linear(x)
    bn, dp = block.bn, block.data_parallel
    if dp is not None and dp.world_size > 1:
        n = y.shape[0] * dp.world_size
        mean = dp.all_reduce_sum(y.sum(dim=0)) / n
        var = dp.all_reduce_sum((y - mean).square().sum(dim=0)) / n
    else:
        mean = y.mean(dim=0)
        var = (y - mean).square().mean(dim=0)
        n = y.shape[0]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean)
        bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased)
    y = torch.relu((y - mean) * torch.rsqrt(var + BN_EPS) * bn.weight + bn.bias)
    keep = 1.0 - block.dropout
    draw = dp.draw_rows(y.shape, generator, y.device) if dp is not None else torch.rand(y.shape, generator=generator)
    return torch.where(draw < keep, y / keep, 0.0)


@pytest.mark.parametrize("ranks", [1, 2])
def test_train_forward_is_the_unfolded_formula_bit_for_bit(ranks):
    """Train mode keeps its formula: over three steps the output, the running
    statistics and the gradients by the input and every parameter are the
    unfolded formula's bits, on one rank and on two ranks' global batch
    (dropout 0.25 throughout).  An eval forward after them folds the moved
    statistics (no cache of an earlier fold) and matches the formula on
    them at 1e-6."""
    rng = np.random.default_rng(12)
    params = _bn_linear_params("signal_laws", rng)
    _, block = _bn_linear(params)
    block.dropout = 0.25
    block.data_parallel = _TwoSameRanks() if ranks > 1 else None
    reference = copy.deepcopy(block)
    x_eval = torch.from_numpy(rng.normal(size=(8, 9)).astype(np.float32))
    with torch.no_grad():
        eval_before = block(x_eval)
    for step in range(3):
        x = torch.from_numpy(rng.normal(size=(513, 9)).astype(np.float32))
        outs, grads = [], []
        for b, forward in ((block, lambda xt, g: block(xt, train=True, generator=g)),
                           (reference, lambda xt, g: _unfolded_train_forward(reference, xt, g))):
            xt = x.clone().requires_grad_()
            out = forward(xt, torch.Generator().manual_seed(step))
            (out * torch.linspace(-1, 1, out.shape[1])).sum().backward()
            outs.append(out.detach())
            grads.append([xt.grad] + [p.grad for p in b.parameters()])
            b.zero_grad(set_to_none=True)
        assert torch.equal(outs[0], outs[1]), step
        assert all(torch.equal(a, b) for a, b in zip(*grads)), step
        for name in ("running_mean", "running_var"):
            assert torch.equal(getattr(block.bn, name), getattr(reference.bn, name)), (step, name)
    with torch.no_grad():
        got = block(x_eval)
        bn = block.bn
        want = torch.relu((block.linear(x_eval) - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
                          + bn.bias)
    assert not torch.equal(got, eval_before)
    _close(got, want.numpy())


# ------------------------------------------------------------ whole models
ATTENTION_DECODER = {  # tests/test_train.py:304
    "block": [
        {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
        {"block_type": "KmerMultipleEmbedding", "input_channel": 66, "output_channel": 2,
         "num_neighboring_features": 1},
        {"block_type": "ConcatenateFeatures"},
        {"block_type": "Linear", "input_channel": 15, "output_channel": 32, "activation": "relu", "batch_norm": True},
        {"block_type": "Attention", "input_channel": 32, "hidden_layers": [16, 1], "n_reads_per_site": 20},
        {"block_type": "Linear", "input_channel": 32, "output_channel": 1, "activation": "sigmoid",
         "batch_norm": False},
    ]
}
SUMMARY_STATS = {  # tests/test_train.py:347
    "block": [
        {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
        {"block_type": "ExtractSignal"},
        {"block_type": "Linear", "input_channel": 9, "output_channel": 8, "activation": "relu", "batch_norm": False},
        {"block_type": "SummaryStatsProbability", "input_channel": 8, "n_reads_per_site": 20},
        {"block_type": "Linear", "input_channel": 40, "output_channel": 1, "activation": "sigmoid",
         "batch_norm": False},
    ]
}
PROBABILITY_ATTENTION = {
    "block": [
        {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
        {"block_type": "KmerMultipleEmbedding", "input_channel": 66, "output_channel": 2,
         "num_neighboring_features": 1},
        {"block_type": "ConcatenateFeatures"},
        {"block_type": "Linear", "input_channel": 15, "output_channel": 16, "activation": "relu", "batch_norm": True},
        {"block_type": "Linear", "input_channel": 16, "output_channel": 4, "activation": "sigmoid",
         "batch_norm": False},
        {"block_type": "ProbabilityAttention", "input_channel": 4, "hidden_layers_1": [8],
         "hidden_layers_2": [4, 1], "n_bins": 5, "sigma": 0.2, "n_reads_per_site": 20},
        {"block_type": "Linear", "input_channel": 40, "output_channel": 1, "activation": "sigmoid",
         "batch_norm": False},
    ]
}
NO_POOLING = {
    "block": [
        {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
        {"block_type": "ExtractSignal"},
        {"block_type": "Linear", "input_channel": 9, "output_channel": 4, "activation": "relu", "batch_norm": True},
        {"block_type": "Linear", "input_channel": 4, "output_channel": 1, "activation": "sigmoid",
         "batch_norm": False},
    ]
}
DEEP_ATTENTION = {  # a block of 12 layers: layers/10 and layers/11 flatten after layers/9
    "block": [
        {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
        {"block_type": "ExtractSignal"},
        {"block_type": "Linear", "input_channel": 9, "output_channel": 6, "activation": "relu", "batch_norm": True},
        {"block_type": "Attention", "input_channel": 6, "activation": "tanh",
         "hidden_layers": [5, 4, 6, 3, 5, 4, 6, 3, 5, 4, 2, 1]},
        {"block_type": "Linear", "input_channel": 6, "output_channel": 1, "activation": "sigmoid",
         "batch_norm": False},
    ]
}


def _signal_config():
    return load_toml(SIGNAL_MODEL_CONFIG)


def _jax_init(config, seed=0):
    model = JaxMILModel(config)
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


def _port(config, params):
    model = MILModel(config)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _batch(seed=0, n_sites=64):
    rng = np.random.default_rng(seed)
    return {
        "X": rng.normal(size=(n_sites, 20, 9)).astype(np.float32),
        "kmer": rng.integers(0, 66, size=(n_sites, 20, 3)).astype(np.int32),
        "y": rng.integers(0, 2, size=n_sites).astype(np.float32),
    }


def test_signal_config_is_the_jax_packages():
    with open(SIGNAL_MODEL_CONFIG, "rb") as a, open(jax_asset_path("configs", "prod_pooling_signal.toml"), "rb") as b:
        assert a.read() == b.read()
    model = MILModel(_signal_config())
    assert [type(b).__name__ for b in model.blocks] == [
        "DeaggregateNanopolish", "ExtractSignal", "Linear", "Linear", "SigmoidProdPooling"]
    assert tuple(model.blocks[2].linear.weight.shape) == (150, 9)
    assert tuple(model.blocks[3].linear.weight.shape) == (32, 150)
    assert not engine.production_architecture(model)


@pytest.mark.parametrize("name", ["signal", "attention_decoder", "summary_stats", "probability_attention",
                                  "deep_attention"])
def test_model_methods_match_jax(name):
    """Every MILModel method the JAX model has, through the carried-across
    init, on seeded reads (20 a site); a method the JAX model raises on
    raises in the port with the same message."""
    config = {"signal": _signal_config(), "attention_decoder": ATTENTION_DECODER, "summary_stats": SUMMARY_STATS,
              "probability_attention": PROBABILITY_ATTENTION, "deep_attention": DEEP_ATTENTION}[name]
    jax_model, params = _jax_init(config)
    model = _port(config, params)
    batch = _batch(3, SITES)
    jb = {"X": jnp.asarray(batch["X"].reshape(-1, 9)), "kmer": jnp.asarray(batch["kmer"].reshape(-1, 3))}
    tb = {"X": torch.from_numpy(batch["X"].reshape(-1, 9)), "kmer": torch.from_numpy(batch["kmer"].reshape(-1, 3))}
    with torch.no_grad():
        _close(model.site_probability(tb), jax_model.site_probability(params, jb)[0], msg="site_probability")
        _close(model.site_representation(tb), jax_model.site_representation(params, jb)[0])
        _close(model.read_representation(tb), jax_model.read_representation(params, jb)[0])
        _close(model.read_probability(tb), jax_model.read_probability(params, jb))
        read, site, rep = model.read_site_probability(tb)
        for got, want in zip((read, site, rep), jax_model.read_site_probability(params, jb)):
            _close(got, want)
        for method in ("per_read_probability", "attention_weights"):
            try:
                want = getattr(jax_model, method)(params, jb)
            except ValueError as err:
                with pytest.raises(ValueError, match=str(err)):
                    getattr(model, method)(tb)
            else:
                _close(getattr(model, method)(tb), want, msg=method)


def test_a_config_without_a_pooling_filter_builds():
    """Repair 1: such a model builds, as in the JAX package; its site
    representation is the read representation and every block is encoder."""
    jax_model, params = _jax_init(NO_POOLING)
    model = _port(NO_POOLING, params)
    assert model.pooling is None and len(model.encoder) == 4 and model.decoder == []
    batch = _batch(4, SITES)
    jb = {"X": jnp.asarray(batch["X"].reshape(-1, 9)), "kmer": jnp.asarray(batch["kmer"].reshape(-1, 3))}
    tb = {"X": torch.from_numpy(batch["X"].reshape(-1, 9)), "kmer": torch.from_numpy(batch["kmer"].reshape(-1, 3))}
    with torch.no_grad():
        got = model.site_probability(tb)
        _close(got, jax_model.site_probability(params, jb)[0])
        assert torch.equal(got, model.read_representation(tb))
    for method in ("per_read_probability", "read_probability", "attention_weights"):
        with pytest.raises(Exception):
            getattr(jax_model, method)(params, jb)
        with pytest.raises(ValueError, match="no pooling filter"):
            getattr(model, method)(tb)


def _demo_dataset(package="port"):
    if package == "jax":
        return jax_build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=JAX_NORM_PATH, mode="Inference")
    return build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=DEFAULT_NORM_PATH, mode="Inference")


@pytest.mark.parametrize("name", ["attention_decoder", "summary_stats_aggregator"])
def test_inference_without_a_per_read_layer_raises_before_any_batch(name, tmp_path):
    """Repair 2: the JAX package's error, from the model and from the
    engine's torch step before it dispatches anything."""
    config = ATTENTION_DECODER
    if name == "summary_stats_aggregator":
        config = {"block": [*SUMMARY_STATS["block"][:3],
                            {"block_type": "SummaryStatsAggregator", "input_channel": 8}]}
    jax_model, params = _jax_init(config)
    model = _port(config, params)
    x = {"X": torch.zeros(40, 9), "kmer": torch.zeros(40, 3, dtype=torch.int32)}
    with pytest.raises(ValueError, match=NO_PER_READ_LAYER):
        jax_model.per_read_probability(params, {k: jnp.asarray(v.numpy()) for k, v in x.items()})
    with pytest.raises(ValueError, match=NO_PER_READ_LAYER):
        model.per_read_probability(x)
    with pytest.raises(ValueError, match=NO_PER_READ_LAYER):
        engine.make_infer_step(model, 16, 0.5)
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=NO_PER_READ_LAYER):
        engine.run_inference(model, _demo_dataset(), str(out), 0.5, device="cpu")
    assert not (out / "data.site_proba.csv").exists()


@pytest.fixture(scope="module")
def generic_runs(tmp_path_factory):
    """The signal-only config and the ProbabilityAttention config through
    the JAX engine (xla) and the port's engine, from one seeded JAX init
    written as a JAX .npz and read by the port."""
    root = tmp_path_factory.mktemp("generic")
    runs = {}
    for name, config in (("signal", _signal_config()), ("probability_attention", PROBABILITY_ATTENTION)):
        jax_model, params = _jax_init(config, seed=7)
        weights = str(root / f"{name}.npz")
        jax_save_tree(weights, params)
        jax_run_inference(jax_model, params, _demo_dataset("jax"), str(root / name / "jax"),
                          read_proba_threshold=DEFAULT_READ_THRESHOLD, backend="xla")
        engine.run_inference(load_model(config, weights), _demo_dataset(), str(root / name / "port"),
                             DEFAULT_READ_THRESHOLD, device="cpu")
        runs[name] = (config, weights, root / name)
    return runs


@pytest.mark.parametrize("name", ["signal", "probability_attention"])
def test_generic_config_inference_matches_the_jax_engine(generic_runs, name):
    _, _, root = generic_runs[name]
    for csv, keys in (("data.indiv_proba.csv", KEYS_I), ("data.site_proba.csv", KEYS_S)):
        got = pd.read_csv(root / "port" / csv).sort_values(keys).reset_index(drop=True)
        want = pd.read_csv(root / "jax" / csv).sort_values(keys).reset_index(drop=True)
        assert len(got) == len(want) == {"data.indiv_proba.csv": 5595, "data.site_proba.csv": 101}[csv]
        assert (got[keys].values == want[keys].values).all()
        atol = 1e-6 if csv == "data.indiv_proba.csv" else 1e-5
        np.testing.assert_allclose(got.probability_modified, want.probability_modified, rtol=0, atol=atol)
        if csv == "data.site_proba.csv":
            np.testing.assert_array_equal(got.mod_ratio, want.mod_ratio)
            assert (got.n_reads == want.n_reads).all() and (got.kmer == want.kmer).all()


@pytest.mark.parametrize("name", ["signal", "probability_attention"])
def test_generic_config_mc_inference_matches_the_jax_engine(generic_runs, name, tmp_path):
    """The MC site method on a generic config: the torch step's draws are
    the JAX xla backend's, so site_p within 1e-5 (f32 sums in another
    order), per read as the exact run."""
    config, weights, _ = generic_runs[name]
    jax_model, params = JaxMILModel(config), load_tree(weights)
    kw = dict(method="mc", num_iterations=100, seed=7)
    jax_run_inference(jax_model, params, _demo_dataset("jax"), str(tmp_path / "jax"),
                      read_proba_threshold=DEFAULT_READ_THRESHOLD, backend="xla", **kw)
    engine.run_inference(load_model(config, weights), _demo_dataset(), str(tmp_path / "port"),
                         DEFAULT_READ_THRESHOLD, device="cpu", **kw)
    for csv, keys, atol in (("data.indiv_proba.csv", KEYS_I, 1e-6), ("data.site_proba.csv", KEYS_S, 1e-5)):
        got = pd.read_csv(tmp_path / "port" / csv).sort_values(keys).reset_index(drop=True)
        want = pd.read_csv(tmp_path / "jax" / csv).sort_values(keys).reset_index(drop=True)
        assert (got[keys].values == want[keys].values).all()
        np.testing.assert_allclose(got.probability_modified, want.probability_modified, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["signal", "probability_attention"])
def test_inference_cli_takes_a_generic_model_config(generic_runs, name, tmp_path):
    """--model_config with a JAX .npz of its tree as --model_state_dict, on
    the CPU: the same bytes as run_inference."""
    config, weights, root = generic_runs[name]
    config_path = str(tmp_path / "model.toml")
    dump_toml(config, config_path)
    out = tmp_path / "cli"
    with pytest.warns(UserWarning, match="model_state_dict"):
        port_main(["inference", "--input_dir", DATA_DIR, "--out_dir", str(out), "--model_config", config_path,
                   "--model_state_dict", weights, "--norm_path", DEFAULT_NORM_PATH,
                   "--read_proba_threshold", str(DEFAULT_READ_THRESHOLD), "--device", "cpu", "--n_processes", "1"])
    for csv in ("data.indiv_proba.csv", "data.site_proba.csv"):
        assert (out / csv).read_bytes() == (root / "port" / csv).read_bytes()


def test_generic_configs_resolve_to_torch_under_auto():
    """On a card, auto takes the torch modules for an architecture the CUDA
    kernels do not cover (the JAX package's auto takes xla); an explicit
    CUDA backend raises naming --backend torch."""
    cuda = torch.device("cuda")
    for config in (_signal_config(), PROBABILITY_ATTENTION, SUMMARY_STATS):
        model = MILModel(config)
        assert engine.resolve_backend(model, "auto", "auto", cuda) == ("torch", "f32")
        for backend in engine.CUDA_BACKENDS:
            with pytest.raises(ValueError, match="--backend torch"):
                engine.resolve_backend(model, backend, "auto", cuda)
        with pytest.raises(ValueError, match="CUDA backends"):
            engine.resolve_backend(model, "auto", "bf16", cuda)


# ------------------------------------------------------------ training
def test_leaf_order_and_adam_state_cross_both_ways():
    """jax_leaf_order is jax.tree_util's flatten order (layers/10 after
    layers/9, not after layers/1); the optax state of a JAX step loads into
    torch Adam and comes back bit for bit; and the port's own step from the
    same parameters leaves the same moments, leaf for leaf."""
    jax_model, params = _jax_init(DEEP_ATTENTION)
    # twice the init's weights keep the attention's logits of order one
    # through its 12 layers, so every layer has a gradient to compare
    params["block3"]["layers"] = [{"w": 2 * layer["w"], "b": layer["b"]} for layer in params["block3"]["layers"]]
    model = _port(DEEP_ATTENTION, params)
    want_order = [
        "/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
    ]
    assert [path for path, _ in jax_leaf_order(model)] == want_order
    assert want_order.index("block3/layers/10/b") == want_order.index("block3/layers/9/w") + 1

    batch = _batch(5)
    optimizer = jax_loop.make_optimizer(LR, 0.0, CLIP)  # no decay: the BatchNorm moments stay 0
    jax_step = jax_loop.make_train_step(jax_model, jax_losses.binary_cross_entropy_loss, optimizer)
    _, opt_state, _, _ = jax_step(params, optimizer.init(params), batch, jax.random.PRNGKey(1))
    jax_leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(opt_state)]
    assert len(jax_leaves) == 1 + 2 * len(want_order)

    port_optimizer = loop.make_optimizer(model, LR)
    adam_state_from_jax(jax_leaves, model, port_optimizer)
    back = adam_state_to_jax(model, port_optimizer)
    assert len(back) == len(jax_leaves)
    for i, (got, want) in enumerate(zip(back, jax_leaves)):
        assert got.dtype == want.dtype and np.array_equal(got, want), i

    fresh = _port(DEEP_ATTENTION, params).train()
    fresh_optimizer = loop.make_optimizer(fresh, LR)
    loop.make_train_step(fresh, losses.binary_cross_entropy_loss, fresh_optimizer, CLIP)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    got_leaves = adam_state_to_jax(fresh, fresh_optimizer)
    assert got_leaves[0] == jax_leaves[0] == 1
    resolved = set()
    for i, path in enumerate(want_order * 2):
        got, want = got_leaves[1 + i], jax_leaves[1 + i]
        assert got.shape == want.shape, path
        # mu = 0.1 g and nu = 0.001 g**2, each leaf within 1e-5 of its
        # largest entry; a BatchNorm statistic's (0) and those of a leaf
        # whose gradient is f32 noise below 1e-6 (the bias before BatchNorm,
        # the attention's last bias) below that on both sides
        bound = 1e-7 if i < len(want_order) else 1e-15
        if np.abs(want).max() < bound:
            assert path.endswith(("bn_mean", "bn_var")) or _zero_in_exact_arithmetic(DEEP_ATTENTION, path), path
            assert np.abs(got).max() < bound, path
            continue
        resolved.add(path)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=path)
    assert {"block3/layers/10/w", "block3/layers/11/w", "block4/w"} <= resolved


def _leaves(tree):
    return flatten_tree(tree)


def _zero_in_exact_arithmetic(config, key):
    """The leaves whose gradient is zero in exact arithmetic, so f32 noise
    (below 1e-6) in both packages: the bias of a Linear block before its
    BatchNorm (which cancels it), and the bias of an attention's last layer
    (the softmax over the reads does not move when every logit shifts)."""
    index, *rest = key.split("/")
    block = config["block"][int(index.removeprefix("block"))]
    if rest == ["b"]:
        return block["block_type"] == "Linear" and block.get("batch_norm", True)
    hidden = block.get("hidden_layers", block.get("hidden_layers_2"))
    last = f"layers/{len(hidden or []) - 1}/b"
    return rest[-3:] == last.split("/") and (len(rest) == 3 or rest[-4] == "attention")


@pytest.mark.parametrize("name", ["attention_decoder", "summary_stats", "probability_attention"])
def test_train_step_matches_jax(name):
    """One step from the JAX init on a seeded batch: loss, site output,
    gradients, updated parameters and BatchNorm statistics (tolerances:
    tests/test_torch_train.py).  The read classifier of
    SummaryStatsProbability and ProbabilityAttention does not reach the
    site output: its gradient is zero on both sides, and it moves by the
    weight decay alone."""
    config = {"attention_decoder": ATTENTION_DECODER, "summary_stats": SUMMARY_STATS,
              "probability_attention": PROBABILITY_ATTENTION}[name]
    jax_model, params = _jax_init(config)
    batch = _batch(1, 256)
    inputs = {"X": batch["X"], "kmer": batch["kmer"]}

    def objective(p):
        pred, _ = jax_model.site_probability(p, inputs, train=True)
        return jax_losses.binary_cross_entropy_loss(pred, batch["y"])

    jax_grads = _leaves(jax.tree.map(np.asarray, jax.grad(objective)(params)))
    optimizer = jax_loop.make_optimizer(LR, WD, CLIP)
    jax_step = jax_loop.make_train_step(jax_model, jax_losses.binary_cross_entropy_loss, optimizer)
    new_params, _, jax_loss, jax_pred = jax_step(params, optimizer.init(params), batch, jax.random.PRNGKey(1))
    assert np.asarray(jax_pred).shape == (256, 1)

    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    grad_model = _port(config, params)
    pred = grad_model.site_probability(tensors, train=True)
    losses.binary_cross_entropy_loss(pred, tensors["y"]).backward()
    grads = _leaves(params_to_jax({k: p.grad for k, p in grad_model.named_parameters() if p.grad is not None}))
    for key, want in jax_grads.items():
        if key.endswith(("bn_mean", "bn_var")):
            continue
        if not np.abs(want).any():  # a leaf the site output does not reach
            assert "read_classifier" in key and key not in grads
            continue
        if _zero_in_exact_arithmetic(config, key):  # f32 noise on both sides
            assert np.abs(grads[key]).max() < 1e-6 and np.abs(want).max() < 1e-6, key
            continue
        np.testing.assert_allclose(grads[key], want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=key)

    model = _port(config, params).train()
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, loop.make_optimizer(model, LR, WD), CLIP)
    loss, pred = step(tensors)
    assert abs(float(loss) - float(jax_loss)) <= 1e-6 * abs(float(jax_loss))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jax_pred), rtol=0, atol=1e-6)
    got = _leaves(params_to_jax(model.state_dict()))
    for key, want in _leaves(jax.tree.map(np.asarray, new_params)).items():
        # Adam's first step is lr * g / (|g| + 1e-8): where |g| < 1e-6 it
        # turns the packages' f32 noise in g into steps up to 2 lr
        unresolved = np.abs(jax_grads[key]) < 1e-6
        if key.endswith(("bn_mean", "bn_var")):
            unresolved[:] = False
        np.testing.assert_allclose(got[key][~unresolved], want[~unresolved], rtol=0, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got[key][unresolved], want[unresolved], rtol=0, atol=2 * LR, err_msg=key)
        if "read_classifier" in key:  # decay alone moved it, and as far as in JAX
            np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-6, err_msg=key)
            assert not np.array_equal(got[key], _leaves(params)[key])


def test_saturation_aware_init_touches_only_a_top_level_bias():
    """As the JAX package's: an instance-pooling filter's bias is set; the
    bias of ProbabilityAttention's read classifier is not."""
    for config in (PROBABILITY_ATTENTION, _signal_config()):
        jax_model, params = _jax_init(config)
        model = _port(config, params)
        loop.saturation_aware_init(model, bias=-4.0)
        want = _leaves(jax.tree.map(np.asarray, jax_loop.saturation_aware_init(jax_model, params, bias=-4.0)))
        got = _leaves(params_to_jax(model.state_dict()))
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key
    assert np.array_equal(got["block4/b"], [-4.0])


def test_train_cli_with_a_generic_model_config(tmp_path):
    """Two epochs of the attention-plus-decoder architecture through the
    train CLI on the CPU: the JAX layout of a nested tree, which the JAX
    package's checkpoint reader takes, optimizer state included."""
    model_config, train_config = str(tmp_path / "model.toml"), str(tmp_path / "train.toml")
    dump_toml(ATTENTION_DECODER, model_config)
    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=DATA_DIR, norm_path=DEFAULT_NORM_PATH)
    dump_toml(cfg, train_config)
    out = tmp_path / "out"
    port_main(["train", "--model_config", model_config, "--train_config", train_config, "--save_dir", str(out),
               "--device", "cpu", "--epochs", "2", "--save_per_epoch", "2", "--num_iterations", "1",
               "--n_processes", "1", "--lr", "2e-3"])
    tree = load_tree(str(out / "avg_loss.npz"))
    assert sorted(_leaves(tree)) == sorted(_leaves(_jax_init(ATTENTION_DECODER)[1]))
    assert tree["block4"]["layers"][1]["w"].shape == (16, 1)
    for name in ("train_results.json", "val_results.json", "test_results_avg_loss.json"):
        assert np.isfinite(pd.read_json(out / name)["avg_loss"]).all()
    with open(out / "train_info.toml", "rb") as f:
        assert tomllib.load(f)["model_config"] == ATTENTION_DECODER
    jax_model = JaxMILModel(ATTENTION_DECODER)
    ckpt = str(out / "model_states" / "2")
    jax_params, opt_state, epoch = jax_checkpoint.restore_checkpoint(ckpt, jax_loop.make_optimizer(2e-3))
    assert epoch == 2 and len(jax.tree_util.tree_leaves(opt_state)) == 1 + 2 * len(_leaves(tree))
    batch = _batch(6, SITES)
    tb = {"X": torch.from_numpy(batch["X"]), "kmer": torch.from_numpy(batch["kmer"])}
    with torch.no_grad():
        got = _port(ATTENTION_DECODER, load_tree(str(out / "model_states" / "2" / "model_states.npz")))
        got = got.site_probability(tb)
    want, _ = jax_model.site_probability(jax_params, {k: jnp.asarray(v) for k, v in batch.items() if k != "y"})
    _close(got, want)
