"""Percentiles and rates over a whole window."""
import numpy as np
import pytest

from perfbench import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 200])
def test_percentile_matches_linear_interpolation(q, n):
    xs = np.random.default_rng(n).exponential(size=n)
    assert stats.percentile(list(xs), q) == pytest.approx(
        float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_by_hand():
    # 21 values 0..20: the 95th percentile sits at rank 19 exactly
    assert stats.percentile(range(21), 95) == 19
    # 0, 10: a quarter of the way
    assert stats.percentile([10, 0], 25) == 2.5
    assert stats.percentile([], 95) is None


def test_rate_is_count_over_the_whole_window():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
