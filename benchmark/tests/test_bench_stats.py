"""The end-to-end arithmetic: rates over the whole window, p95 over all requests."""

import numpy as np
import pytest

from harness import readers, stats


def test_rate_is_all_work_over_all_time():
    # two requests of unequal length: the mean of per-request rates would
    # read (100/1 + 100/3) / 2 = 66.7; the window's rate is 200 / 4
    assert stats.rate(200.0, 4.0) == 50.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


@pytest.mark.parametrize("n", [1, 2, 19, 20, 500])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).exponential(size=n))
    assert stats.percentile(xs, 95.0) == pytest.approx(float(np.percentile(xs, 95.0)))


def test_p95_is_over_all_requests_not_chunks():
    # 100 requests: 90 fast and 10 slow.  The p95 of all requests is slow;
    # a p95 of per-chunk means (chunks of 10) would be fast.
    walls = [0.01] * 90 + [1.0] * 10
    ctx = {"records": [{"wall_s": w} for w in walls]}
    assert readers.wall_p95(ctx) == pytest.approx(1.0)
    chunk_means = [sum(walls[i:i + 10]) / 10 for i in range(0, 100, 10)]
    assert stats.percentile(chunk_means, 95.0) < 1.0


def test_work_rate_reads_any_entry_records():
    ctx = {"window_s": 2.0, "records": [{"work": 3.0}, {"work": 5.0}]}
    assert readers.work_rate(ctx) == 4.0
    # an entry that keeps no such count gives nothing to read, never 0
    assert readers.work_rate({"window_s": 2.0, "records": [{"wall_s": 1.0}]}) is None
    assert readers.iterations_per_knot({"records": [{"work": 1.0}]}) is None


def test_step_mfu_is_the_windows_operations_over_its_time():
    ctx = {"window_s": 2.0, "records": [{"ops": 1e12}, {"ops": 3e12}]}
    assert readers.step_mfu(ctx) == pytest.approx(100.0 * 4e12 / (2.0 * 34e12))
