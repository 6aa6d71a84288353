"""The yardstick's arithmetic on hand-made inputs."""

import pytest

from bhbench import arith


def test_one_stall_moves_the_tail():
    steady = [10.0 + 0.01 * i for i in range(20)]
    stalled = steady[:-1] + [500.0]
    assert arith.percentile(steady, 95) < 10.2
    assert arith.percentile(stalled, 95) > 30.0


def test_percentile_interpolates_between_ranks():
    assert arith.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert arith.percentile([0.0, 10.0], 95) == pytest.approx(9.5)


def test_idle_share_of_a_synthetic_timeline():
    # Busy 0-2, 3-4 and 3.5-5 (overlapping) in a window of 0-10: 4 s busy.
    busy = [(0.0, 2.0), (3.0, 4.0), (3.5, 5.0), (11.0, 12.0)]
    assert arith.union_seconds(busy[:3]) == pytest.approx(4.0)
    assert arith.idle_share(busy, 0.0, 10.0) == pytest.approx(60.0)
    assert arith.idle_gaps(busy, 0.0, 10.0) == [(2.0, 3.0), (5.0, 10.0)]
    assert arith.idle_share([(-1.0, 20.0)], 0.0, 10.0) == pytest.approx(0.0)


def test_spread_is_the_interquartile_distance_over_the_median():
    assert arith.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_roofline_counts_the_least_operations():
    assert arith.least_seconds(0, 67e9) == pytest.approx(731.1e-3)
    assert arith.least_seconds(2, 1e9) == pytest.approx(4063.2e9 / 67e12)
    assert arith.roofline_share(1.0, 4.0) == pytest.approx(25.0)
    assert arith.roofline_share(1.0, 0.0) is None
