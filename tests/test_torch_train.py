"""The port's training path on the CPU: analogs of tests/test_train.py, and
parity with the JAX package on the same inputs.

Inputs are made with numpy from a seed; the port starts from the JAX
package's parameters carried across by ``params_from_jax`` where the two
are compared.  Tolerances (PERF.md, "Training"):

* one train step: the loss within 1e-6 relative, every gradient within
  1e-5 of its leaf's largest entry, every updated leaf and the BatchNorm
  running statistics within 1e-6, the train-mode outputs of the updated
  model within 1e-6.  ``block3/b``, the Linear bias right before
  BatchNorm, is the exception: BatchNorm cancels it, so its true gradient
  is zero, each package's is f32 noise below 1e-6, and Adam's normalised
  first step, lr g / (|g| + 1e-8), turns that noise into steps of order
  lr; it is held to 2 lr.  From a fresh init it is the only such leaf.
  From the released weights a few more elements have gradients below
  1e-6 (dead units, cancellations): they are held to 2 lr as well, and
  the updated model's outputs to 1e-5 (the port's own updated parameters
  through the JAX model: 1e-6).
* two epochs on the demo's labelled sites: train losses within 1e-4
  relative; validation losses within 1e-3 relative, as ``block3/b``'s
  drift reaches eval outputs through ``running_mean``; ROC and PR AUC
  within 0.06 (two of the Val split's 2 x 17 positive-negative pairs
  ranked the other way).
"""
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (jax before torch, see conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m6anet_tpu.constants import DEFAULT_NORM_PATH as JAX_NORM_PATH
from m6anet_tpu.data import loader as jax_loader
from m6anet_tpu.data import samplers as jax_samplers
from m6anet_tpu.data.dataset import SiteDataset as JaxSiteDataset
from m6anet_tpu.models.mil import MILModel as JaxMILModel
from m6anet_tpu.models.mil import load_model as jax_load_model
from m6anet_tpu.train import checkpoint as jax_checkpoint
from m6anet_tpu.train import loop as jax_loop
from m6anet_tpu.train import losses as jax_losses
from m6anet_tpu.utils.treeio import load_tree as jax_load_tree
from m6anet_tpu_torch.constants import (
    DEFAULT_MODEL_CONFIG,
    DEFAULT_NORM_PATH,
    PRETRAINED_CONFIGS,
    TRAIN_CONFIG_TEMPLATE,
)
from m6anet_tpu_torch.data.dataset import SiteDataset
from m6anet_tpu_torch.data.loader import TrainLoader
from m6anet_tpu_torch.data import samplers
from m6anet_tpu_torch.models.blocks import Linear
from m6anet_tpu_torch.models.convert import adam_state_to_jax, params_from_jax, params_to_jax
from m6anet_tpu_torch.models.mil import MILModel, load_model
from m6anet_tpu_torch.train import checkpoint, loop, losses
from m6anet_tpu_torch.train.metrics import get_accuracy, get_pr_auc, get_roc_auc
from m6anet_tpu_torch.utils.config import dump_toml, load_toml
from m6anet_tpu_torch.utils.treeio import load_tree, save_tree

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD, CLIP = 4e-3, 1e-5, 5.0
BIAS_BEFORE_BN = ("block3", "b")


def _config():
    return load_toml(DEFAULT_MODEL_CONFIG)


def _batch(seed=0, n_sites=256):
    rng = np.random.default_rng(seed)
    return {
        "X": rng.normal(size=(n_sites, 20, 9)).astype(np.float32),
        "kmer": rng.integers(0, 66, size=(n_sites, 20, 3)).astype(np.int32),
        "y": rng.integers(0, 2, size=n_sites).astype(np.float32),
    }


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(jax_params):
    model = MILModel(_config())
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params)))
    return model


def _jax_model_and_params(source):
    model = JaxMILModel(_config())
    if source == "init":
        return model, model.init(jax.random.PRNGKey(0))
    return model, model.load_npz(PRETRAINED_CONFIGS[source][0])


def _leaves(tree):
    return {(blk, leaf): np.asarray(v) for blk in tree for leaf, v in tree[blk].items()}


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("masked", [False, True])
def test_bce_matches_torch_semantics_and_jax(masked):
    rng = np.random.default_rng(0)
    y_pred = rng.uniform(0.01, 0.99, size=32).astype(np.float32)
    y_true = rng.integers(0, 2, size=32).astype(np.float32)
    mask = (np.arange(32) < 27).astype(np.float32) if masked else None
    kw = {} if mask is None else {"mask": torch.from_numpy(mask)}
    jkw = {} if mask is None else {"mask": jnp.asarray(mask)}
    p, y = torch.from_numpy(y_pred), torch.from_numpy(y_true)

    ours = float(losses.binary_cross_entropy_loss(p, y, **kw))
    elem = torch.nn.BCELoss(reduction="none")(p, y)
    m = torch.ones(32) if mask is None else torch.from_numpy(mask)
    assert abs(ours - float((elem * m).sum() / m.sum())) < 1e-6
    jax_plain = float(jax_losses.binary_cross_entropy_loss(jnp.asarray(y_pred), jnp.asarray(y_true), **jkw))
    assert abs(ours - jax_plain) <= 1e-6 * abs(jax_plain)

    # weighted: label-0 -> n_pos, label-1 -> n_neg (inverse-frequency pairing)
    n_pos = float((y * m).sum())
    n_neg = float(m.sum()) - n_pos
    w = torch.where(y == 0, n_pos, n_neg)
    expected = float((elem * w * m).sum() / m.sum())
    ours_w = float(losses.weighted_binary_cross_entropy_loss(p, y, **kw))
    assert abs(ours_w - expected) < 1e-4
    jax_w = float(jax_losses.weighted_binary_cross_entropy_loss(jnp.asarray(y_pred), jnp.asarray(y_true), **jkw))
    assert abs(ours_w - jax_w) <= 1e-6 * abs(jax_w)


def test_weighted_bce_falls_back_to_plain_on_one_class():
    y_pred = torch.tensor([0.2, 0.7, 0.9])
    ones = torch.ones(3)
    got = losses.weighted_binary_cross_entropy_loss(y_pred, ones)
    torch.testing.assert_close(got, losses.binary_cross_entropy_loss(y_pred, ones), rtol=0, atol=0)
    want = jax_losses.weighted_binary_cross_entropy_loss(jnp.asarray(y_pred.numpy()), jnp.ones(3))
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


def test_bce_gradient_finite_at_saturation():
    """The noisy-OR saturates site probabilities at exactly 0.0/1.0; torch's
    BCE backward (p - y) / max(p (1 - p), 1e-12) is huge but finite there,
    and is what the JAX package's custom_vjp imitates."""
    y_pred = np.array([0.0, 1.0, 1e-30, 1.0 - 1e-7, 0.3], np.float32)
    y_true = np.array([1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    p = torch.tensor(y_pred, requires_grad=True)
    losses.binary_cross_entropy_loss(p, torch.from_numpy(y_true)).backward()
    assert torch.isfinite(p.grad).all(), p.grad

    tp = torch.tensor(y_pred, requires_grad=True)
    torch.nn.BCELoss()(tp, torch.from_numpy(y_true)).backward()
    torch.testing.assert_close(p.grad, tp.grad, rtol=0, atol=0)
    g = jax.grad(lambda q: jax_losses.binary_cross_entropy_loss(q, jnp.asarray(y_true)))(jnp.asarray(y_pred))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-6)


def test_loss_registry_builds_by_name():
    fn = losses.build_loss_function({"loss_function_type": "weighted_binary_cross_entropy_loss"})
    assert fn is losses.weighted_binary_cross_entropy_loss
    assert sorted(losses.LOSS_REGISTRY) == sorted(jax_losses.LOSS_REGISTRY)
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.build_loss_function({"loss_function_type": "hinge"})


# ------------------------------------------------------- metrics, config
@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_sklearn(seed):
    """ROC and PR AUC equal scikit-learn's roc_curve / precision_recall_curve
    + auc (the JAX package's metrics), ties included."""
    from sklearn.metrics import accuracy_score, auc, precision_recall_curve, roc_curve

    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 400))
    y = rng.integers(0, 2, size=n).astype(np.float32)
    score = np.round(rng.uniform(size=n), seed + 1).astype(np.float32)  # ties
    fpr, tpr, _ = roc_curve(y, score)
    precision, recall, _ = precision_recall_curve(y, score, pos_label=1)
    assert get_roc_auc(y, score) == auc(fpr, tpr)
    assert get_pr_auc(y, score) == auc(recall, precision)
    guess = (score > 0.5).astype(np.float32)
    assert get_accuracy(y, guess) == accuracy_score(y, guess)


def test_treeio_roundtrip(tmp_path):
    tree = {
        "block1": {"embedding": np.arange(6, dtype=np.float32).reshape(3, 2)},
        "block5": {"layers": [{"w": np.ones((2, 2))}, {"w": np.zeros((2, 1))}]},
    }
    path = os.path.join(tmp_path, "t.npz")
    save_tree(path, tree)
    for back in (load_tree(path), jax_load_tree(path)):
        assert isinstance(back["block5"]["layers"], list)
        np.testing.assert_array_equal(back["block1"]["embedding"], tree["block1"]["embedding"])
        np.testing.assert_array_equal(back["block5"]["layers"][1]["w"], tree["block5"]["layers"][1]["w"])


def test_toml_dump_roundtrip(tmp_path):
    cfg = {
        "model": "prod",
        "block": [{"block_type": "Linear", "input_channel": 15}, {"block_type": "SigmoidProdPooling"}],
        "dataloader": {"train": {"batch_size": 256, "shuffle": True}},
    }
    path = os.path.join(tmp_path, "c.toml")
    dump_toml(cfg, path)
    assert load_toml(path) == cfg
    template = load_toml(TRAIN_CONFIG_TEMPLATE)
    assert template["dataloader"]["train"]["sampler"] in samplers.SAMPLER_REGISTRY


# ------------------------------------------------------ datasets, loaders
@pytest.fixture(scope="module")
def train_datasets():
    common = dict(root_dir=DATA_DIR, min_reads=20, norm_path=DEFAULT_NORM_PATH)
    return SiteDataset(**common, mode="Train"), SiteDataset(**common, mode="Val")


@pytest.fixture(scope="module")
def jax_train_datasets():
    common = dict(root_dir=DATA_DIR, min_reads=20, norm_path=JAX_NORM_PATH)
    return JaxSiteDataset(**common, mode="Train"), JaxSiteDataset(**common, mode="Val")


def test_samplers_balance(train_datasets):
    train_ds, _ = train_datasets
    labels = np.asarray(train_ds.labels)
    for cls in (samplers.ImbalanceUnderSampler, samplers.ImbalanceOverSampler):
        sampler = cls(train_ds)
        idx = np.fromiter(iter(sampler), dtype=int)
        assert len(idx) == len(sampler)
        counts = np.bincount(labels[idx])
        assert counts[0] == counts[1]
    for cls in (samplers.ImbalanceKmerUnderSampler, samplers.ImbalanceKmerOverSampler):
        sampler = cls(train_ds)
        idx = np.fromiter(iter(sampler), dtype=int)
        assert len(idx) == len(sampler) > 0


@pytest.mark.parametrize("name", sorted(samplers.SAMPLER_REGISTRY))
def test_samplers_draw_as_jax(name, train_datasets, jax_train_datasets):
    """One numpy seed, the same epochs in both packages."""
    epochs = {}
    for pkg, ds in ((samplers, train_datasets[0]), (jax_samplers, jax_train_datasets[0])):
        np.random.seed(11)
        sampler = pkg.SAMPLER_REGISTRY[name](ds)
        epochs[pkg] = [np.fromiter(iter(sampler), dtype=int) for _ in range(2)]
    for ours, theirs in zip(epochs[samplers], epochs[jax_samplers]):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize(
    "kwargs",
    [dict(batch_size=16, shuffle=True), dict(batch_size=16, drop_last=True), dict(batch_size=10, pad_to_multiple=4)],
)
def test_loader_batches_match_jax(kwargs, train_datasets, jax_train_datasets):
    """The same numpy seed and one worker give the same batches: the same
    sites, the same reads drawn for each, the same padding and n_valid."""
    batches = {}
    for pkg, ds in ((TrainLoader, train_datasets[0]), (jax_loader.TrainLoader, jax_train_datasets[0])):
        np.random.seed(5)
        batches[pkg] = list(pkg(ds, num_workers=1, **kwargs))
    ours, theirs = batches[TrainLoader], batches[jax_loader.TrainLoader]
    assert len(ours) == len(theirs) == len(TrainLoader(train_datasets[0], num_workers=1, **kwargs))
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() and a["n_valid"] == b["n_valid"]
        for key in ("X", "kmer", "y"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    if kwargs.get("pad_to_multiple"):
        assert all(len(b["y"]) % 4 == 0 for b in ours) and ours[-1]["n_valid"] < len(ours[-1]["y"])


# ------------------------------------------------------------ the blocks
def test_init_draws_the_jax_laws():
    model = MILModel(_config()).init(torch.Generator().manual_seed(3))
    again = MILModel(_config()).init(torch.Generator().manual_seed(3))
    other = MILModel(_config()).init(torch.Generator().manual_seed(4))
    sd, sd_again, sd_other = model.state_dict(), again.state_dict(), other.state_dict()
    assert all(torch.equal(sd[k], sd_again[k]) for k in sd)
    assert not torch.equal(sd["blocks.3.linear.weight"], sd_other["blocks.3.linear.weight"])
    for index, fan_in in ((3, 15), (4, 150), (5, 32)):
        for tensor in (sd[f"blocks.{index}.linear.weight"], sd[f"blocks.{index}.linear.bias"]):
            assert tensor.abs().max() <= 1 / np.sqrt(fan_in)
        assert sd[f"blocks.{index}.linear.weight"].abs().max() > 0.9 / np.sqrt(fan_in)
    emb = sd["blocks.1.embedding.weight"]
    assert abs(float(emb.mean())) < 0.3 and 0.7 < float(emb.std()) < 1.3
    assert torch.equal(sd["blocks.3.bn.weight"], torch.ones(150))
    assert torch.equal(sd["blocks.3.bn.running_var"], torch.ones(150))
    assert not sd["blocks.3.bn.bias"].any() and not sd["blocks.3.bn.running_mean"].any()
    # the tree carries across and the JAX model runs it
    jax_model = JaxMILModel(_config())
    batch = _batch(2, 8)
    want, _ = jax_model.site_probability(params_to_jax(sd), {"X": batch["X"], "kmer": batch["kmer"]})
    with torch.no_grad():
        got = model.site_probability(_tensors(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_dropout_keep_rate_and_scale():
    torch.manual_seed(0)
    block = Linear(64, 512, activation=None, batch_norm=False, dropout=0.25)
    x = torch.randn(256, 64)
    with torch.no_grad():
        plain = block(x)
        dropped = block(x, train=True, generator=torch.Generator().manual_seed(1))
        repeat = block(x, train=True, generator=torch.Generator().manual_seed(1))
        assert torch.equal(block(x, generator=None), plain)  # eval: no dropout
    kept = dropped != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(dropped[kept], plain[kept] / 0.75, rtol=0, atol=0)
    assert torch.equal(dropped, repeat)
    with pytest.raises(ValueError, match="generator"):
        block(x, train=True)


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("source", ["init", "HCT116_RNA002"])
def test_train_step_matches_jax(source):
    """One step from the same parameters on a seeded 256 x 20 batch: loss,
    gradients, updated parameters, BatchNorm statistics and the updated
    model's train-mode outputs (tolerances: module docstring)."""
    jax_model, jax_params = _jax_model_and_params(source)
    batch = _batch(1)
    model = _port_model(jax_params)
    grad_model = _port_model(jax_params)

    def objective(p):
        pred, _ = jax_model.site_probability(p, {"X": batch["X"], "kmer": batch["kmer"]}, train=True)
        return jax_losses.binary_cross_entropy_loss(pred, batch["y"])

    jax_grads = jax.grad(objective)(jax_params)
    optimizer = jax_loop.make_optimizer(LR, WD, CLIP)
    jax_step = jax_loop.make_train_step(jax_model, jax_losses.binary_cross_entropy_loss, optimizer)
    new_params, _, jax_loss, jax_pred = jax_step(jax_params, optimizer.init(jax_params), batch, jax.random.PRNGKey(1))

    pred = grad_model.site_probability(_tensors(batch), train=True)
    losses.binary_cross_entropy_loss(pred, _tensors(batch)["y"]).backward()
    grads = _leaves(params_to_jax({k: p.grad for k, p in grad_model.named_parameters()}))
    for key, want in _leaves(jax_grads).items():
        if key[1] in ("bn_mean", "bn_var"):
            continue
        if key == BIAS_BEFORE_BN:  # zero in exact arithmetic: f32 noise on both sides
            assert np.abs(grads[key]).max() < 1e-6 and np.abs(want).max() < 1e-6
            continue
        np.testing.assert_allclose(grads[key], want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=str(key))

    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, loop.make_optimizer(model, LR, WD), CLIP)
    loss, pred = step(_tensors(batch))
    assert abs(float(loss) - float(jax_loss)) <= 1e-6 * abs(float(jax_loss))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jax_pred), rtol=0, atol=1e-6)
    got = _leaves(params_to_jax(model.state_dict()))
    jax_grads = _leaves(jax_grads)
    for key, want in _leaves(new_params).items():
        # Adam's first step is lr * g / (|g| + 1e-8): where |g| < 1e-6 it
        # turns the packages' f32 noise in g (~1e-9) into steps up to 2 lr
        unresolved = np.abs(jax_grads[key]) < 1e-6
        if key == BIAS_BEFORE_BN:
            assert unresolved.all()
        elif source == "init":  # from a fresh init, block3/b is the only such leaf
            assert not unresolved.any() or key[1] in ("bn_mean", "bn_var"), key
        if key[1] in ("bn_mean", "bn_var"):
            unresolved[:] = False
        np.testing.assert_allclose(got[key][~unresolved], want[~unresolved], rtol=0, atol=1e-6, err_msg=str(key))
        np.testing.assert_allclose(got[key][unresolved], want[unresolved], rtol=0, atol=2 * LR, err_msg=str(key))
    assert not np.array_equal(got[("block3", "bn_mean")], _leaves(jax_params)[("block3", "bn_mean")])

    probe = _batch(2, 64)
    inputs = {"X": probe["X"], "kmer": probe["kmer"]}
    same_params, _ = jax_model.site_probability(params_to_jax(model.state_dict()), inputs, train=True)
    want, _ = jax_model.site_probability(new_params, inputs, train=True)
    with torch.no_grad():
        got_out = model.site_probability(_tensors(probe), train=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(same_params), rtol=0, atol=1e-6)
    # from the released weights, the few elements Adam could not resolve
    # (above) move site_p by up to ~3e-6
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want), rtol=0, atol=1e-6 if source == "init" else 1e-5)


def test_clip_is_optax_formula():
    grads = [torch.tensor([3.0, 0.0]), torch.tensor([4.0])]  # norm 5
    loop.clip_by_global_norm_(grads, 5.0)  # not below max_norm: g / 5 * 5
    assert [g.tolist() for g in grads] == [[3.0, 0.0], [4.0]]
    loop.clip_by_global_norm_(grads, 2.5)
    assert [g.tolist() for g in grads] == [[1.5, 0.0], [2.0]]
    small = [torch.tensor([0.3, 0.4])]
    loop.clip_by_global_norm_(small, 1.0)
    assert small[0].tolist() == [0.30000001192092896, 0.4000000059604645]


# ------------------------------------------------------------ the loop
def test_two_epochs_on_the_demo_match_jax(train_datasets, jax_train_datasets):
    """Two epochs on the demo's labelled sites from the same parameters,
    the same numpy seed and one loader worker (tolerances: module
    docstring)."""
    jax_model, jax_params = _jax_model_and_params("init")
    kw = dict(save_per_epoch=2, n_iterations=2, seed=0)
    results = {}
    for pkg in ("jax", "port"):
        np.random.seed(3)
        if pkg == "jax":
            train_ds, val_ds = jax_train_datasets
            loaders = (
                jax_loader.TrainLoader(train_ds, 16, sampler=jax_samplers.ImbalanceOverSampler(train_ds), num_workers=1),
                jax_loader.TrainLoader(val_ds, 16, num_workers=1),
            )
            _, tr, vr = jax_loop.train(jax_model, jax_params, *loaders, jax_loop.make_optimizer(LR, WD, CLIP), 2,
                                       jax_losses.binary_cross_entropy_loss, **kw)
        else:
            train_ds, val_ds = train_datasets
            loaders = (
                TrainLoader(train_ds, 16, sampler=samplers.ImbalanceOverSampler(train_ds), num_workers=1),
                TrainLoader(val_ds, 16, num_workers=1),
            )
            model = _port_model(jax_params)
            tr, vr = loop.train(model, *loaders, loop.make_optimizer(model, LR, WD), 2,
                                losses.binary_cross_entropy_loss, clip_grad=CLIP, **kw)
        results[pkg] = tr, vr
    (jtr, jvr), (ptr, pvr) = results["jax"], results["port"]
    np.testing.assert_allclose(ptr["avg_loss"], jtr["avg_loss"], rtol=1e-4)
    np.testing.assert_allclose(pvr["avg_loss"], jvr["avg_loss"], rtol=1e-3)
    for key in ("roc_auc", "pr_auc"):
        np.testing.assert_allclose(ptr[key], jtr[key], rtol=0, atol=0.06)
        np.testing.assert_allclose(pvr[key], jvr[key], rtol=0, atol=0.06)
    np.testing.assert_array_equal(pvr["y_true"][0], jvr["y_true"][0])


def test_training_learns(train_datasets, tmp_path):
    train_ds, val_ds = train_datasets
    train_ds.rng = np.random.RandomState(0)
    val_ds.rng = np.random.RandomState(1)
    np.random.seed(0)
    model = MILModel(_config()).init(torch.Generator().manual_seed(0))
    train_dl = TrainLoader(train_ds, batch_size=32, shuffle=True, num_workers=2)
    val_dl = TrainLoader(val_ds, batch_size=32, num_workers=2)
    try:
        tr, vr = loop.train(
            model, train_dl, val_dl, loop.make_optimizer(model, LR, WD), n_epoch=4,
            loss_fn=losses.binary_cross_entropy_loss, save_dir=str(tmp_path), clip_grad=CLIP,
            save_per_epoch=2, n_iterations=2, seed=0,
        )
    finally:
        train_ds.rng = val_ds.rng = np.random
    assert len(tr["avg_loss"]) == len(vr["avg_loss"]) == 4
    assert np.isfinite(tr["avg_loss"]).all() and np.isfinite(vr["avg_loss"]).all()
    assert tr["avg_loss"][-1] < tr["avg_loss"][0]
    for epoch in ("2", "4"):
        assert os.path.exists(os.path.join(tmp_path, "model_states", epoch, "model_states.npz"))
    # BN running stats must have moved away from init
    assert model.blocks[3].bn.running_mean.abs().max() > 0


def test_detect_stall_window():
    plateau_l, plateau_r = [6.9] * 25, [0.50] * 25
    assert loop.detect_stall(plateau_l, plateau_r, patience=20)
    assert not loop.detect_stall(plateau_l[:10], plateau_r[:10], patience=20)
    assert not loop.detect_stall(plateau_l[:-1] + [1.2], plateau_r, patience=20)
    assert not loop.detect_stall(plateau_l, plateau_r[:-1] + [0.9], patience=20)
    assert not loop.detect_stall(plateau_l, plateau_r, patience=0)
    assert (loop.STALL_LOSS_RANGE, loop.STALL_ROC_RANGE) == (jax_loop.STALL_LOSS_RANGE, jax_loop.STALL_ROC_RANGE)


def test_reseed_on_stall_restarts(train_datasets):
    """With lr=0 nothing leaves the fresh-init plateau, so a wide detection
    window fires after `patience` epochs and training restarts with derived
    seeds until the budget is spent."""
    train_ds, val_ds = train_datasets
    model = MILModel(_config()).init(torch.Generator().manual_seed(0))
    train_dl = TrainLoader(train_ds, batch_size=32, num_workers=1)
    val_dl = TrainLoader(val_ds, batch_size=32, num_workers=1)
    init_seeds = []

    def init_fn(s):
        init_seeds.append(s)
        model.init(torch.Generator().manual_seed(s))

    optimizer = loop.make_optimizer(model, 0.0)
    tr, vr = loop.train(
        model, train_dl, val_dl, optimizer, n_epoch=3, loss_fn=losses.binary_cross_entropy_loss,
        save_per_epoch=3, seed=7, init_fn=init_fn, reseed_on_stall=True, stall_patience=2, max_restarts=2,
        stall_loss_range=(0.0, 1e6), stall_roc_range=(0.0, 1.0),
    )
    assert init_seeds == [7 + 9973, 7 + 2 * 9973]
    assert len(tr["avg_loss"]) == 3 and len(vr["avg_loss"]) == 3
    want = MILModel(_config()).init(torch.Generator().manual_seed(7 + 2 * 9973)).state_dict()
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want if "running" not in k and "num_batches" not in k)

    with pytest.raises(ValueError, match="init_fn"):
        loop.train(model, train_dl, val_dl, optimizer, n_epoch=1, loss_fn=losses.binary_cross_entropy_loss,
                   save_per_epoch=1, reseed_on_stall=True)


def test_saturation_aware_init_escapes_fixed_point():
    model = MILModel(_config()).init(torch.Generator().manual_seed(0))
    batch = _tensors(_batch(0, 16))
    w = model.blocks[3].linear.weight.clone()
    with torch.no_grad():
        fresh = model.site_probability(batch)
        biased = loop.saturation_aware_init(model, bias=-4.0).site_probability(batch)
    assert float(fresh.min()) > 0.99  # the fixed point: saturated at ~1
    assert float(biased.max()) < 0.9  # bias breaks the saturation
    assert torch.equal(model.blocks[5].linear.bias, torch.tensor([-4.0]))
    assert torch.equal(model.blocks[3].linear.weight, w)  # only the probability layer's bias changed


# ------------------------------------------------------------ checkpoints
def _stepped_port_model(seed=0):
    model = MILModel(_config()).init(torch.Generator().manual_seed(seed))
    optimizer = loop.make_optimizer(model, 1e-3, WD)
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, optimizer)
    step(_tensors(_batch(seed, 8)))
    return model, optimizer, step


def test_checkpoint_resume_roundtrip(tmp_path):
    model, optimizer, step = _stepped_port_model()
    ckpt = str(tmp_path / "model_states" / "3")
    checkpoint.save_checkpoint(ckpt, model, optimizer, 3)
    assert checkpoint.latest_checkpoint(str(tmp_path)) == ckpt

    model2 = MILModel(_config())
    optimizer2 = loop.make_optimizer(model2, 1e-3, WD)
    assert checkpoint.restore_checkpoint(ckpt, model2, optimizer2) == 3
    sd, sd2 = model.state_dict(), model2.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd if "num_batches" not in k)
    for a, b in zip(adam_state_to_jax(model, optimizer), adam_state_to_jax(model2, optimizer2)):
        np.testing.assert_array_equal(a, b)

    # stepping the restored state matches stepping the original
    batch = _tensors(_batch(2, 8))
    step2 = loop.make_train_step(model2, losses.binary_cross_entropy_loss, optimizer2)
    l1, _ = step(batch)
    l2, _ = step2(batch)
    assert float(l1) == float(l2)
    sd, sd2 = model.state_dict(), model2.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd if "num_batches" not in k)


def test_jax_checkpoint_resumes_in_the_port(train_datasets, jax_train_datasets, tmp_path):
    """A checkpoint directory written by the JAX package's train() resumes
    in the port: stepping both from it gives the same loss."""
    jax_model, jax_params = _jax_model_and_params("init")
    optimizer = jax_loop.make_optimizer(LR, WD, CLIP)
    train_ds, val_ds = jax_train_datasets
    np.random.seed(0)
    jax_loop.train(jax_model, jax_params, jax_loader.TrainLoader(train_ds, 32, num_workers=1),
                   jax_loader.TrainLoader(val_ds, 32, num_workers=1), optimizer, 1,
                   jax_losses.binary_cross_entropy_loss, save_dir=str(tmp_path), save_per_epoch=1)
    ckpt = checkpoint.latest_checkpoint(str(tmp_path))
    jax_params, opt_state, epoch = jax_checkpoint.restore_checkpoint(ckpt, optimizer)

    model = MILModel(_config())
    port_optimizer = loop.make_optimizer(model, LR, WD)
    assert checkpoint.restore_checkpoint(ckpt, model, port_optimizer) == epoch == 1
    jax_leaves = jax.tree_util.tree_leaves(opt_state)
    assert len(jax_leaves) == 23 and int(jax_leaves[0]) == 2  # two batches of 32 of the 57 sites
    for got, want in zip(adam_state_to_jax(model, port_optimizer), jax_leaves):
        if np.asarray(got).ndim and not np.asarray(got).any():
            continue  # a BatchNorm statistic's inert moments (JAX's are nonzero)
        np.testing.assert_array_equal(got, np.asarray(want))

    batch = _batch(4)
    jax_step = jax_loop.make_train_step(jax_model, jax_losses.binary_cross_entropy_loss, optimizer)
    _, _, jax_loss, _ = jax_step(jax_params, opt_state, batch, jax.random.PRNGKey(0))
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, port_optimizer, CLIP)
    loss, _ = step(_tensors(batch))
    assert abs(float(loss) - float(jax_loss)) <= 1e-6 * abs(float(jax_loss))
    loss2, _ = step(_tensors(batch))
    _, _, jax_loss2, _ = jax_step(*jax_step(jax_params, opt_state, batch, jax.random.PRNGKey(0))[:2], batch,
                                  jax.random.PRNGKey(1))
    assert abs(float(loss2) - float(jax_loss2)) <= 1e-5 * abs(float(jax_loss2))


def test_port_checkpoint_restores_in_jax(tmp_path):
    model, optimizer, step = _stepped_port_model(1)
    ckpt = str(tmp_path / "model_states" / "1")
    checkpoint.save_checkpoint(ckpt, model, optimizer, 1)
    jax_optimizer = jax_loop.make_optimizer(1e-3, WD)
    params, opt_state, epoch = jax_checkpoint.restore_checkpoint(ckpt, jax_optimizer)
    assert epoch == 1
    got = _leaves(params)
    for key, want in _leaves(params_to_jax(model.state_dict())).items():
        np.testing.assert_array_equal(got[key], want)
    count = jax.tree_util.tree_leaves(opt_state)[0]
    assert int(count) == 1 and np.asarray(count).dtype == np.int32

    batch = _batch(3, 8)
    jax_step = jax_loop.make_train_step(JaxMILModel(_config()), jax_losses.binary_cross_entropy_loss, jax_optimizer)
    _, _, jax_loss, _ = jax_step(params, opt_state, batch, jax.random.PRNGKey(0))
    loss, _ = step(_tensors(batch))
    assert abs(float(loss) - float(jax_loss)) <= 1e-6 * abs(float(jax_loss))


# ------------------------------------------------------------ the CLI
def _write_train_config(tmp_path, **dataset):
    cfg = load_toml(TRAIN_CONFIG_TEMPLATE)
    cfg["dataset"].update(root_dir=DATA_DIR, norm_path=DEFAULT_NORM_PATH, **dataset)
    path = os.path.join(tmp_path, "train.toml")
    dump_toml(cfg, path)
    return path


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The train CLI on the CPU, in a process where scikit-learn and JAX
    cannot be imported (the card's machine has neither)."""
    tmp = tmp_path_factory.mktemp("train_cli")
    cfg = _write_train_config(tmp)
    out = os.path.join(tmp, "out")
    code = (
        "import sys; sys.modules['sklearn'] = None; sys.modules['jax'] = None; "
        "from m6anet_tpu_torch.cli import main; main(sys.argv[1:])"
    )
    argv = ["train", "--train_config", cfg, "--save_dir", out, "--device", "cpu", "--epochs", "2",
            "--save_per_epoch", "2", "--num_iterations", "1", "--n_processes", "2", "--lr", "4e-3"]
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return out, proc.stdout


def test_train_cli_on_cpu_writes_the_jax_layout(cli_run):
    out, stdout = cli_run
    assert "There are 57 train sites" in stdout and "There are 19 val sites" in stdout
    for name in ("train_info.toml", "train_results.json", "val_results.json", "avg_loss.npz", "roc_auc.npz",
                 "pr_auc.npz", *(f"test_results_{c}.json" for c in ("avg_loss", "roc_auc", "pr_auc"))):
        assert os.path.exists(os.path.join(out, name)), name
    info = load_toml(os.path.join(out, "train_info.toml"))
    assert info["train_config"]["epochs"] == 2 and info["model_config"] == _config()
    for name in ("train_results.json", "val_results.json"):
        with open(os.path.join(out, name)) as f:
            res = json.load(f)
        assert set(res) == {"compute_time", "avg_loss", "roc_auc", "pr_auc"} and len(res["avg_loss"]) == 2
        assert np.isfinite(res["avg_loss"]).all()
    ckpt = os.path.join(out, "model_states", "2")
    assert sorted(os.listdir(ckpt)) == ["meta.json", "model_states.npz", "opt_state.npz"]
    with np.load(os.path.join(ckpt, "opt_state.npz")) as data:
        assert len(data.files) == 23
    # every npz holds exactly the JAX package's parameter tree
    jax_tree = JaxMILModel(_config()).init(jax.random.PRNGKey(0))
    want = {(b, leaf): np.shape(v) for b in jax_tree for leaf, v in jax_tree[b].items()}
    for name in ("avg_loss.npz", os.path.join("model_states", "2", "model_states.npz")):
        tree = jax_load_tree(os.path.join(out, name))
        assert {key: v.shape for key, v in _leaves(tree).items()} == want


def test_trained_weights_run_in_both_packages(cli_run):
    """The port's avg_loss.npz through the port's model and inference
    engine, and through the JAX package's load_model."""
    from m6anet_tpu_torch.constants import DEFAULT_MIN_READS
    from m6anet_tpu_torch.data.dataset import build_dataset
    from m6anet_tpu_torch.inference.engine import run_inference

    weights = os.path.join(cli_run[0], "avg_loss.npz")
    model = load_model(_config(), weights)
    jax_model, jax_params = jax_load_model(_config(), weights)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 9)).astype(np.float32)
    K = rng.integers(0, 66, size=(2000, 3)).astype(np.int32)
    want = np.asarray(jax_model.per_read_probability(jax_params, {"X": jnp.asarray(X), "kmer": jnp.asarray(K)}))
    with torch.no_grad():
        got = model.per_read_probability({"X": torch.from_numpy(X), "kmer": torch.from_numpy(K)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    import pandas as pd

    out = os.path.join(cli_run[0], "inference")
    ds = build_dataset(DATA_DIR, min_reads=DEFAULT_MIN_READS, norm_path=DEFAULT_NORM_PATH, mode="Inference")
    run_inference(model, ds, out, 0.5, device="cpu")
    site = pd.read_csv(os.path.join(out, "data.site_proba.csv"))
    indiv = pd.read_csv(os.path.join(out, "data.indiv_proba.csv"))
    assert len(site) == 101 and len(indiv) == 5595
    assert np.isfinite(site.probability_modified).all() and np.isfinite(indiv.probability_modified).all()


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    from m6anet_tpu_torch.cli import main

    cfg = _write_train_config(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["train", "--train_config", cfg, "--save_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Named for what it held while ``--use_mesh on`` and ``format =
    "columnar"`` were not ported.  Both are (tests/test_torch_distributed.py,
    tests/test_torch_columnar.py); what is refused now is a run they cannot
    make: ``--use_mesh on`` outside a launcher's job, and a columnar
    dataset with no store."""
    from m6anet_tpu_torch.cli import main
    from m6anet_tpu_torch.scripts import train as train_script

    base = ["--train_config", "c.toml", "--save_dir", "out"]
    for value in ("auto", "off", "on"):
        assert train_script.argparser().parse_args([*base, "--use_mesh", value]).use_mesh == value
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    cfg = _write_train_config(tmp_path)
    with pytest.raises(RuntimeError, match="launcher's environment"):
        main(["train", "--train_config", cfg, "--save_dir", str(tmp_path / "mesh"), "--device", "cpu",
              "--use_mesh", "on", "--epochs", "1", "--save_per_epoch", "1"])
    assert not os.path.exists(tmp_path / "mesh")
    cfg = _write_train_config(tmp_path, format="columnar")
    with pytest.raises(FileNotFoundError, match="--format columnar"):
        main(["train", "--train_config", cfg, "--save_dir", str(tmp_path / "out"), "--device", "cpu",
              "--epochs", "1", "--save_per_epoch", "1"])
