"""The end-to-end arithmetic, over every frame of a window."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, interpolated
    linearly between order statistics (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(n: int, seconds: float) -> float:
    """Work over the whole window: ``n`` items in ``seconds``, the drain
    included by the caller."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return n / seconds


def latencies_ms(due, done) -> list:
    """Open-loop latency of each frame: from its due time to the return of
    its call, in ms (a frame sent late because an earlier one stalled
    carries that wait)."""
    return [1e3 * (b - a) for a, b in zip(due, done)]

