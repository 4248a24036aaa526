"""The mixes' requests are a pure function of the seed, with the same sizes for every seed."""

import numpy as np
import pytest

from benchmark import cell, traffic

SEEDS = [0, 7, 2**31 + 11, 2**63 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_offline_batches_are_a_function_of_the_seed(seed):
    mix = cell.mix_file("offline-long")
    pool_a, pool_b = traffic.noise_pool(mix, seed, 16000), traffic.noise_pool(mix, seed, 16000)
    assert np.array_equal(pool_a, pool_b)
    for k in (0, 3, 1 << 40):
        a = traffic.offline_batch(mix, seed, k, pool_a, 16000)
        b = traffic.offline_batch(mix, seed, k, pool_b, 16000)
        assert len(a) == mix["batch_size"] and all(np.array_equal(x, y) for x, y in zip(a, b))
        lens = np.array([len(x) for x in a])
        assert lens.min() >= 20 * 16000 and lens.max() <= 60 * 16000


def test_every_seed_gets_the_same_sizes_in_another_order():
    mix = cell.mix_file("offline-long")
    totals = [sum(traffic.offline_batch_lengths(mix, s, k, 16000).sum() for k in range(60)) / 16000 for s in SEEDS]
    # one length in each of 16 strata a batch: 60 batches' input seconds agree within 0.2 %
    assert max(totals) / min(totals) < 1.002
    orders = [tuple(traffic.offline_batch_lengths(mix, s, 0, 16000)) for s in SEEDS]
    assert len(set(orders)) == len(SEEDS)


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_requests_are_a_function_of_the_seed(seed):
    mix = cell.mix_file("serve-short")
    a = traffic.open_loop_requests(mix, seed, 30.0, 16000, 1280)
    b = traffic.open_loop_requests(mix, seed, 30.0, 16000, 1280)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    n = len(a["due"])
    assert n == round(mix["rate_per_s"] * 30.0)
    assert (a["kind"] == 0).sum() == round(n * mix["encode_share"])
    assert np.all(np.diff(a["due"]) >= 0) and a["due"].min() >= 0 and a["due"].max() < 30.0
    assert a["length"].min() >= 16000 - 1280 and a["length"].max() <= 20 * 16000
    pool = traffic.noise_pool(mix, seed, 16000)
    i = int(np.flatnonzero(a["kind"] == 0)[0])
    assert np.array_equal(traffic.request_audio(pool, a["length"][i], seed, i),
                          traffic.request_audio(traffic.noise_pool(mix, seed, 16000), a["length"][i], seed, i))
    j = int(np.flatnonzero(a["kind"] == 1)[0])
    codes = traffic.request_codes(seed, j, 8, a["length"][j] // 1280, 2016)
    assert codes.shape == (8, a["length"][j] // 1280) and codes.min() >= 0 and codes.max() < 2016


def test_open_loop_lengths_follow_the_clipped_lognormal():
    mix = cell.mix_file("serve-short")
    lens = traffic.stratified_lengths(mix["length"], 4000, 1, 16000) / 16000
    assert abs(np.median(lens) - 5.0) < 0.1 and lens.min() >= 1.0 and lens.max() <= 20.0
