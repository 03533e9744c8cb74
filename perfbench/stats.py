"""Percentiles and rates over a whole window."""
from __future__ import annotations


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) of ``values`` with linear
    interpolation between closest ranks (numpy's default), None when there
    are no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """``count`` per second over ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"rate over a window of {seconds} s")
    return count / seconds
