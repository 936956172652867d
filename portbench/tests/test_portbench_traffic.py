"""The traffic generator: a frozen copy of the port's production batch, the
same sizes for every seed."""
import numpy as np
import pytest

from portbench import traffic


@pytest.mark.parametrize("seed,index", [(0, 0), (2**31 + 11, 5)])
def test_batches_are_the_production_batch_of_seed_and_index(seed, index):
    from m6anet_tpu_torch.scripts import _sweep

    mix = traffic.load("step.exact")
    assert (mix["reads"], mix["sites"]) == (_sweep.READS, _sweep.SITES)
    got = traffic.make_batch(mix, seed, index)
    want = _sweep.production_batch([seed, index])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["step.exact", "step.mc"])
def test_every_seed_stages_the_same_shapes_with_every_site_real(name):
    mix = dict(traffic.load(name), batches=3, reads=65536, sites=1024)
    for seed in (1, 2**31 + 3):
        batches = traffic.make_batches(mix, seed, threads=2)
        assert len(batches) == 3
        for b in batches:
            assert b.features.shape == (65536, 9) and b.kmer_ids.shape == (65536, 3)
            assert b.counts.min() >= 20 and b.counts.max() <= 1000 and b.counts.sum() <= 65536
            assert np.array_equal(b.offsets, np.cumsum(b.counts) - b.counts)
            assert 0 <= b.kmer_ids.min() and b.kmer_ids.max() < 66


def test_threads_do_not_change_the_batches():
    mix = dict(traffic.load("step.exact"), batches=3, reads=16384, sites=128)
    one, many = traffic.make_batches(mix, 7, threads=1), traffic.make_batches(mix, 7, threads=3)
    assert all(np.array_equal(x, y) for a, b in zip(one, many) for x, y in zip(a, b))
