"""The torch backend's per-read tail on the CPU: which models the kernel of
``encoder_kernel.read_prob_tail`` takes, the image it reads against the
modules' folded weights, its layout against csrc/fused_infer.cu's
constants, and the engine's torch step around it.  The kernel itself, and
the kernel file's choice of plan, run only on a card
(``tests/test_torch_cuda.py``)."""
import copy
import tomllib

import numpy as np
import pytest
import torch

from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, DEFAULT_READ_THRESHOLD, SIGNAL_MODEL_CONFIG
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.models.mil import MILModel
from m6anet_tpu_torch.ops import _build, encoder_kernel
from m6anet_tpu_torch.ops import fused_infer_kernel as fik


def _toml(path):
    with open(path, "rb") as f:
        return tomllib.load(f)


def _linear(n_in, n_out, activation="relu", batch_norm=False):
    return {"block_type": "Linear", "input_channel": n_in, "output_channel": n_out, "activation": activation,
            "batch_norm": batch_norm}


PRODUCTION_HEAD = [
    {"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1},
    {"block_type": "KmerMultipleEmbedding", "input_channel": 66, "output_channel": 2, "num_neighboring_features": 1},
    {"block_type": "ConcatenateFeatures"},
]
SIGNAL_HEAD = [{"block_type": "DeaggregateNanopolish", "num_neighboring_features": 1}, {"block_type": "ExtractSignal"}]
PROBABILITY_ATTENTION = {"block_type": "ProbabilityAttention", "input_channel": 32, "hidden_layers_1": [16],
                         "hidden_layers_2": [8, 1], "n_bins": 4, "sigma": 0.5, "n_reads_per_site": 20,
                         "read_classifier": "prod_pooling"}


def _config(head, l1, l2, pool):
    return {"block": head + [l1, l2, pool]}


# name -> (model config, the widths of the tail the kernel takes, or None)
CONFIGS = {
    "signal": (_toml(SIGNAL_MODEL_CONFIG), (9, 150, 32)),
    "production": (_toml(DEFAULT_MODEL_CONFIG), (15, 150, 32)),
    "probability_attention": (
        _config(PRODUCTION_HEAD, _linear(15, 150, batch_norm=True), _linear(150, 32), PROBABILITY_ATTENTION),
        (15, 150, 32)),
    "summary_stats_probability": (
        _config(SIGNAL_HEAD, _linear(9, 64), _linear(64, 16, batch_norm=True),
                {"block_type": "SummaryStatsProbability", "input_channel": 16, "read_classifier": "mean_pooling"}),
        (9, 64, 16)),
    "max_pooling": (
        _config(SIGNAL_HEAD, _linear(9, 40, batch_norm=True), _linear(40, 8, batch_norm=True),
                {"block_type": "SigmoidMaxPooling", "input_channel": 8}),
        (9, 40, 8)),
    # no per-read probability layer
    "attention": (
        _config(SIGNAL_HEAD, _linear(9, 150), _linear(150, 32),
                {"block_type": "Attention", "input_channel": 32, "hidden_layers": [16, 1]}),
        None),
    # an activation other than relu
    "tanh": (
        _config(SIGNAL_HEAD, _linear(9, 150), _linear(150, 32, activation="tanh"),
                {"block_type": "SigmoidProdPooling", "input_channel": 32}),
        None),
    # one Linear block before the filter
    "one_linear": (
        {"block": SIGNAL_HEAD[:1] + [_linear(9, 32), {"block_type": "SigmoidProdPooling", "input_channel": 32}]},
        None),
    # n_in + H2 past the fast plan's 144 values a read: split and packed
    # here, but the kernel file plans it wide, so the card runs its modules
    # (tests/test_torch_cuda.py)
    "past_the_fast_plan": (
        _config(PRODUCTION_HEAD, _linear(15, 150, batch_norm=True), _linear(150, 132),
                {"block_type": "SigmoidProdPooling", "input_channel": 132}),
        (15, 150, 132)),
}


def _model(name, seed=0):
    model = MILModel(copy.deepcopy(CONFIGS[name][0])).init(torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():  # running statistics away from their init, so the fold does something
        for blk in model.blocks:
            bn = getattr(blk, "bn", None)
            if bn is not None:
                g = torch.Generator().manual_seed(seed + 1)
                bn.weight.copy_(torch.rand(bn.weight.shape, generator=g) + 0.5)
                bn.bias.copy_(torch.rand(bn.bias.shape, generator=g) - 0.5)
                bn.running_mean.copy_(torch.rand(bn.running_mean.shape, generator=g) - 0.5)
                bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) + 0.2)
    return model


def _batch(n=777, seed=3):
    rng = np.random.default_rng(seed)
    features = torch.from_numpy(rng.normal(size=(n, 9)).astype(np.float32))
    kmer_ids = torch.from_numpy(rng.integers(0, 66, size=(n, 3)).astype(np.int8))
    counts = np.array([1, 20, 300, 56, 400, 0, 0], np.int32)
    offsets = np.where(counts > 0, np.cumsum(counts) - counts, 0).astype(np.int32)
    return features, kmer_ids, torch.from_numpy(offsets), torch.from_numpy(counts)


def _unpack(tp):
    """(W1 (H1, n_in), b1, W2 (H2, H1), b2, w3 (H2,), b3 (1,)) as the tail's
    image holds them, read by csrc/fused_infer.cu's layout
    (``fused_infer_kernel.f32_layout``)."""
    w, img = tp.widths, tp.packed
    lay = fik.f32_layout(w)
    rows = img[: w.hidden1 * lay["kW1Stride"]].view(w.hidden1, lay["kW1Stride"])
    fan = img[lay["kOffW2"] : lay["kOffB2"]].view(w.hidden1, lay["kH2Pad"])
    return (rows[:, : w.n_in], rows[:, w.n_in], fan[:, : w.hidden2].t(),
            img[lay["kOffB2"] : lay["kOffB2"] + w.hidden2], img[lay["kOffW3"] : lay["kOffW3"] + w.hidden2],
            img[lay["kOffB3"] : lay["kOffB3"] + 1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_which_models_take_the_fused_tail(name):
    model, widths = _model(name), CONFIGS[name][1]
    tp = encoder_kernel.prepare_tail_params(model)
    if widths is None:
        assert encoder_kernel.tail_blocks(model) is None and tp is None
        return
    assert tp.widths == encoder_kernel.TailWidths(*widths)
    assert tp.head == tuple(model.encoder[:-2])  # the blocks before the tail, the model's own
    assert tp.packed.dtype == torch.float32 and tp.packed.numel() == fik.f32_layout(tp.widths)["kWeights"]
    assert not tp.packed.requires_grad
    # the CPU's step runs the modules: no tail there
    assert encoder_kernel.tail_params(model) is None


@pytest.mark.parametrize("name", ["signal", "probability_attention", "summary_stats_probability", "max_pooling"])
def test_packed_tail_unpacks_to_the_modules_folded_weights(name):
    """Each tail's image, unpacked: bit for bit what ``Linear.folded`` gives
    (BatchNorm on layer 1, layer 2, both or neither), and within f32
    rounding of the fold taken in float64; every padding word zero."""
    model = _model(name)
    l1, l2, head = encoder_kernel.tail_blocks(model)
    tp = encoder_kernel.prepare_tail_params(model)
    w1, b1, w2, b2, w3, b3 = _unpack(tp)
    with torch.no_grad():
        for got, want in zip((w1, b1, w2, b2, w3, b3), (*l1.folded(), *l2.folded(), head.weight[0], head.bias)):
            assert torch.equal(got, want)
        for blk, (w, b) in ((l1, (w1, b1)), (l2, (w2, b2))):
            blk64 = copy.deepcopy(blk).double()
            w64, b64 = blk64.folded()
            np.testing.assert_allclose(w.double().numpy(), w64.numpy(), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(b.double().numpy(), b64.numpy(), rtol=1e-6, atol=1e-7)
    assert (l1.bn is not None, l2.bn is not None) == {
        "signal": (True, False), "probability_attention": (True, False), "summary_stats_probability": (False, True),
        "max_pooling": (True, True)}[name]
    lay = fik.f32_layout(tp.widths)
    img = tp.packed
    rows = img[: tp.widths.hidden1 * lay["kW1Stride"]].view(tp.widths.hidden1, lay["kW1Stride"])
    fan = img[lay["kOffW2"] : lay["kOffB2"]].view(tp.widths.hidden1, lay["kH2Pad"])
    assert lay["kOffEmb"] == lay["kOffW2"]  # no embedding table
    assert not rows[:, tp.widths.n_in + 1 :].any() and not fan[:, tp.widths.hidden2 :].any()
    assert not img[lay["kOffB3"] + 1 :].any()


@pytest.mark.parametrize("widths", [(9, 150, 32), (15, 150, 32), (9, 64, 16), (1, 1, 1), (112, 20, 32),
                                    (113, 20, 32), (15, 150, 128), (15, 150, 129), (120, 1500, 24)])
def test_the_tail_envelope_is_the_kernels_fast_plan(widths):
    """The image against csrc/fused_infer.cu's constants as a build with
    tail_defines evaluates them: the inputs a read, no k-mer position or
    embedding word, the image's offsets; and the widths the file plans
    fast (kReadValues within kMaxReadValues, the image within a block's
    shared memory), the only ones whose tail the card takes (its library's
    ``read_prob_wide``, ``encoder_kernel.tail_params``)."""
    w = encoder_kernel.TailWidths(*widths)
    c = _build.cu_constants("fused_infer", encoder_kernel.tail_defines(w))
    lay = fik.f32_layout(w)
    assert {k: c[k] for k in lay} == lay
    assert (c["kFeat"], c["kIn"], c["kPos"], c["kEmbWords"], c["kH1"], c["kH2"]) == (w.n_in, w.n_in, 0, 0, w.hidden1,
                                                                                    w.hidden2)
    fast = c["kReadValues"] <= c["kMaxReadValues"] and 4 * c["kWeights"] <= c["kSharedLimit"]
    assert fast == (widths not in {(113, 20, 32), (15, 150, 129), (120, 1500, 24)})


@pytest.mark.parametrize("method", ["exact", "mc"])
@pytest.mark.parametrize("name", ["signal", "production", "tanh"])
def test_the_cpu_step_runs_the_modules_bit_for_bit(name, method):
    """On the CPU the torch step is the modules' per-read probability, bit
    for bit, and launches nothing, whether or not the kernel takes the
    model's tail."""
    model = _model(name)
    batch = _batch()
    before = encoder_kernel.launch_count
    step = engine.make_infer_step(model, 7, DEFAULT_READ_THRESHOLD, method=method, backend="torch")
    with torch.no_grad():
        p, site_p, mod_ratio = step(*batch)
        want = model.per_read_probability({"X": batch[0], "kmer": batch[1]})
    assert torch.equal(p, want) and encoder_kernel.launch_count == before
    assert site_p.shape == mod_ratio.shape == (7,)


def _tail_plain(tp, x):
    """The tail's function over its image, in float32 matmuls."""
    w1, b1, w2, b2, w3, b3 = _unpack(tp)
    h2 = torch.relu(torch.relu(x @ w1.t() + b1) @ w2.t() + b2)
    return torch.sigmoid(h2 @ w3 + b3)


@pytest.mark.parametrize("method", ["exact", "mc"])
@pytest.mark.parametrize("name", ["signal", "production", "probability_attention", "tanh"])
def test_a_step_with_the_tail_runs_the_blocks_before_it(monkeypatch, name, method):
    """The step as a card builds it, with the kernel's launch replaced by
    the tail's function over its image: the blocks before the tail run as
    modules (the production head's embedding and concatenation among
    them) and the tail takes their output, so p is the modules' within f32
    rounding (1e-6), and the site outputs follow.  A model the kernel does
    not take gets no tail, and the modules' bits."""
    calls = []

    def plain(tp, x):
        calls.append(tuple(x.shape))
        assert x.is_contiguous() and x.dtype == torch.float32
        return _tail_plain(tp, x)

    monkeypatch.setattr(encoder_kernel, "tail_params", encoder_kernel.prepare_tail_params)
    monkeypatch.setattr(encoder_kernel, "read_prob_tail", plain)
    model = _model(name)
    batch = _batch()
    step = engine.make_infer_step(model, 7, DEFAULT_READ_THRESHOLD, method=method, backend="torch")
    with torch.no_grad():
        got = step(*batch)
        monkeypatch.undo()
        want = engine.make_infer_step(model, 7, DEFAULT_READ_THRESHOLD, method=method, backend="torch")(*batch)
    widths = CONFIGS[name][1]
    if widths is None:
        assert calls == [] and all(torch.equal(a, b) for a, b in zip(got, want))
        return
    assert calls == [(batch[0].shape[0], widths[0])]
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


def test_read_prob_tail_runs_only_on_a_card():
    tp = encoder_kernel.prepare_tail_params(_model("signal"))
    with pytest.raises(ValueError, match="runs on cuda"):
        encoder_kernel.read_prob_tail(tp, torch.zeros(4, 9))
