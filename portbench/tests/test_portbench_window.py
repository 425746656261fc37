"""The window's arithmetic on synthetic update times: a rate over all the
work and all the time, percentiles over all updates."""
import statistics
import time

import pytest

from portbench import window
from portbench.metrics import msamples_per_s, update_ms_p90
from portbench.run import Context


def test_quantile_matches_inclusive_interpolation():
    xs = [0.31, 0.12, 0.5, 0.07, 0.9, 0.33, 0.2]
    for q in (0.1, 0.5, 0.9):
        ref = statistics.quantiles(xs, n=10, method="inclusive")[
            int(round(q * 10)) - 1]
        assert window.quantile(xs, q) == pytest.approx(ref, rel=1e-12)
    assert window.quantile([3.0], 0.9) == 3.0
    with pytest.raises(ValueError):
        window.quantile([], 0.5)


def test_p90_sees_a_stall_that_a_median_hides():
    times = [0.1] * 85 + [2.0] * 15  # a stall in 15 of 100 updates
    assert window.quantile(times, 0.5) == pytest.approx(0.1)
    assert window.quantile(times, 0.9) == pytest.approx(2.0)
    # one stall in 100 updates stays below the 90th percentile
    assert window.quantile([0.1] * 99 + [2.0], 0.9) == pytest.approx(0.1)


def test_rate_is_over_all_work_and_all_time():
    times = [0.1] * 9 + [1.1]  # 2 s in all, one update stalled
    ctx = Context("c", {}, {}, 0.0, times, sum(times), 10 * 1_000_000, 0, {})
    assert msamples_per_s.read(ctx) == pytest.approx(5.0)
    assert update_ms_p90.read(ctx) == pytest.approx(200.0)
    # the median update would claim twice the rate
    assert 1_000_000 / window.quantile(times, 0.5) == pytest.approx(1e7)


def test_run_ends_with_the_update_in_flight():
    calls = []

    def update():
        calls.append(1)
        time.sleep(0.02)

    times, span = window.run(update, 0.05)
    assert len(times) == len(calls) >= 3
    assert span >= 0.05 and span == pytest.approx(sum(times), rel=0.2)
    times, _ = window.run(update, 10.0, max_updates=2)
    assert len(times) == 2
