"""The comparison that decides ``correct`` fails what it must: a whole run
on the CPU at a small size (the card's look skipped, the port's wrappers on
their plain versions), with the timed path broken underneath; and the
control, the reference in TF32 in the port's place.  A sound run passes."""
import pytest
import torch

from portbench import calibrate, harness

SMALL = {"batches": 3, "reads": 16384, "sites": 192}
CELLS = {  # the (backend, precision) the card resolves for each cell
    "m6anet.step.exact": ("cuda_fused", "f32x3"),
    "m6anet_signal.step.exact": ("torch", "f32"),
    "m6anet.step.mc": ("cuda_fused", "f32x3"),
}


def stale(step):
    """A step that returns its first outputs for every batch."""
    first = []

    def broken(*args, **kwargs):
        if not first:
            first.append(step(*args, **kwargs))
        return first[0]

    return broken


def half(step):
    """Each site's statistics over the first half of its reads."""

    def broken(features, kmer_ids, offsets, counts, host_sites=None, host_kmer_ids=None):
        host_sites = None if host_sites is None else (host_sites[0], host_sites[1] // 2)
        return step(features, kmer_ids, offsets, torch.div(counts, 2, rounding_mode="floor"),
                    host_sites=host_sites, host_kmer_ids=host_kmer_ids)

    return broken


def altered(which, by):
    """One answer changed where it is produced: output ``which``'s element 5."""

    def wrap(step):
        def broken(*args, **kwargs):
            outputs = [t.clone() for t in step(*args, **kwargs)]
            outputs[which][5] += by
            return tuple(outputs)

        return broken

    return wrap


FAULTS = {"stale": stale, "half": half, "p": altered(0, 0.01), "site_p": altered(1, 0.01),
          "mod_ratio": altered(2, 1.0 / 64)}


def run(workload, wrap_step=None, seed=2**31 + 101):
    return harness.run(workload, seed, 0.05, False, "cpu", mix_override=SMALL, resolved=CELLS[workload],
                       wrap_step=wrap_step, log=lambda msg: None)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"sites_per_s.mc" if workload.endswith(".mc") else "sites_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_broken_step_is_not_correct(workload, fault):
    result = run(workload, FAULTS[fault])
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_fails_the_limits(workload):
    limits = harness.load_json(harness.HERE, "limits", workload + ".json")
    readings = calibrate.readings(workload, [2**31 + 202], True, 0.0, "cpu", mix_override=SMALL,
                                  resolved=CELLS[workload], log=lambda msg: None)
    worst = readings[2**31 + 202]
    assert any(worst[name] > limits[name] for name in limits)
