"""Percentiles over every request; rates over the whole window."""

import numpy as np
import pytest

from benchmark.loops.http_open_loop import latency_stats, percentile
from tiny import tiny_run


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_numpys_linear_percentile(q):
    x = np.random.default_rng(q).lognormal(size=1237)
    assert percentile(x, q) == pytest.approx(float(np.percentile(x, q)), rel=1e-12)


def test_latency_set_is_every_request_with_the_unanswered_at_the_deadline():
    res = {"status": [200, 200, 503, 0, 200, 500], "latency": [0.1, 0.3, float("nan"), float("nan"), 0.2, float("nan")],
           "due": [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], "lateness": [0.0] * 6}
    s = latency_stats(res, deadline_s=70.0)
    assert s["attempted"] == 6 and s["failed"] == 3 and s["refused"] == 1
    assert sorted(s["latency_s"]) == [0.1, 0.2, 0.3, 65.0, 67.0, 68.0]
    assert percentile(s["latency_s"] * 1e3, 50) == pytest.approx((300.0 + 65000.0) / 2)


def test_shedding_load_cannot_shorten_the_tail():
    """Refusing the slowest tenth of the requests raises the p95 instead of lowering it."""
    rng = np.random.default_rng(3)
    lat = rng.lognormal(-2.0, 0.5, size=1000)
    due = np.sort(rng.random(1000) * 50.0)
    served = {"status": [200] * 1000, "latency": lat.tolist(), "due": due.tolist(), "lateness": [0.0] * 1000}
    slow = lat >= np.quantile(lat, 0.9)
    shed = dict(served, status=np.where(slow, 503, 200).tolist(), latency=np.where(slow, np.nan, lat).tolist())
    p95 = lambda res: percentile(latency_stats(res, deadline_s=110.0)["latency_s"], 95)
    assert p95(shed) > p95(served)


def test_offline_rate_is_all_input_over_the_whole_window():
    """audio_x_realtime = input seconds of every batch started in the window over
    the time from its start to the completion of the last one."""
    from benchmark.loops import offline

    _, run = tiny_run("codec-int8.offline-long", seed=5, seconds=1.0)
    offline.run(run)
    c = run.counters
    assert run.attempted == c["batches"] * run.mix["batch_size"]
    assert c["window_s"] >= run.seconds
    assert run.end_to_end["audio_x_realtime"] == pytest.approx(c["input_audio_s"] / c["window_s"])
    from benchmark import traffic

    total = sum(traffic.offline_batch_lengths(run.mix, 5, k, 16000).sum() for k in range(c["batches"])) / 16000
    assert c["input_audio_s"] == pytest.approx(total)
