"""The plain reference against the port on the CPU at a small size: both
configurations, both site methods, on the torch backend (the signal cell's
path) and on the plain versions of the fused CUDA step (the m6anet cells')."""
import numpy as np
import pytest
import torch

from portbench import check, harness, traffic
from portbench.reference import mlp, threefry

SMALL = {"batches": 2, "reads": 16384, "sites": 192}
CPU = torch.device("cpu")


def port_outputs(config_name, mix, weights, batch, seed, backend, precision):
    from m6anet_tpu_torch.inference import engine
    from m6anet_tpu_torch.models.convert import params_from_jax
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.ops import fused_infer_kernel
    from m6anet_tpu_torch.utils.treeio import unflatten_tree

    config = harness.load_json(harness.HERE, "configs", config_name + ".json")
    model = MILModel(config["model"])
    model.load_state_dict(params_from_jax(unflatten_tree(dict(weights))))
    model.eval()
    step = engine.make_infer_step(model, mix["sites"], config["read_proba_threshold"], 20, mix["site_method"],
                                  backend, n_iterations=mix.get("num_iterations", 1000), seed=seed,
                                  precision=precision)
    with torch.no_grad():
        return step(*(torch.from_numpy(a) for a in batch), host_sites=(batch.offsets, batch.counts),
                    host_kmer_ids=fused_infer_kernel.checked_kmer_ids(batch.kmer_ids))


@pytest.mark.parametrize("config_name,traffic_name,backend,precision,p_tol", [
    ("m6anet", "step.exact", "torch", "f32", 2e-6),
    ("m6anet", "step.mc", "torch", "f32", 2e-6),
    ("m6anet_signal", "step.exact", "torch", "f32", 2e-6),
    ("m6anet_signal", "step.mc", "torch", "f32", 2e-6),
    ("m6anet", "step.exact", "cuda_fused", "f32x3", 2e-5),
    ("m6anet", "step.mc", "cuda_fused", "f32x3", 2e-5),
])
def test_reference_matches_the_port(config_name, traffic_name, backend, precision, p_tol):
    from m6anet_tpu_torch.ops import site_ops

    seed = 2**31 + 29
    config = harness.load_json(harness.HERE, "configs", config_name + ".json")
    mix = dict(traffic.load(traffic_name), **SMALL)
    weights = harness.make_weights(config, seed, CPU)
    batch = traffic.make_batch(mix, seed, 1)
    outputs = port_outputs(config_name, mix, weights, batch, seed, backend, precision)
    u = None
    if mix["site_method"] == "mc":  # the torch backend draws U in chunks of its own
        chunk = site_ops.mc_chunk_size(1000, mix["sites"]) if backend == "torch" else 1024
        u = torch.from_numpy(threefry.shared_draws(seed, 1000, 20, chunk))
    staged = tuple(torch.from_numpy(a) for a in batch)
    reference = check.reference_outputs(check.reference_module(config_name), mlp.tensors(weights, "f64", CPU),
                                        staged, config["read_proba_threshold"], mix["site_method"], 20, u, "f64")
    numbers = check.batch_numbers(outputs, reference, staged[2], staged[3], config["read_proba_threshold"])
    assert numbers["p_err"] < p_tol
    assert numbers["site_p_err"] < 2e-5
    assert numbers["mod_ratio_wrong"] == 0


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
@pytest.mark.parametrize("iters,chunk", [(1000, 1024), (1500, 1024), (1000, 64)])
def test_threefry_copy_gives_the_ports_draws(seed, iters, chunk):
    from m6anet_tpu_torch.ops import random

    assert np.array_equal(threefry.shared_draws(seed, iters, 20, chunk), random.shared_draws(seed, iters, 20, chunk))


def test_tf32_round_keeps_ten_mantissa_bits_rounding_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -(1.0 + 3 * 2**-12), 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 3.0], dtype=torch.float32)
    assert torch.equal(mlp.tf32_round(x), want)
    bits = mlp.tf32_round(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0
