"""Order statistics and interval arithmetic."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile over every sample, by linear
    interpolation between the order statistics (NumPy's default);
    ``None`` for no samples."""
    xs = sorted(float(x) for x in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med


def union(intervals) -> list[tuple[float, float]]:
    """Merge ``(start, end)`` intervals into disjoint sorted ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Each interval cut to ``[lo, hi]``; those outside dropped."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of ``[lo, hi]`` that no interval of the merged,
    clipped ``busy`` covers."""
    out = []
    at = lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out
