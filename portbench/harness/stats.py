"""The arithmetic every cell shares: rates over a window, tails over all
requests, and busy and idle time from intervals. Plain Python, so that the
CPU tests hold it on synthetic intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def window_rate(work: float, start: float, end: float) -> float:
    """All the work of a window over all its time."""
    if end <= start:
        raise ValueError(f"empty window [{start}, {end}]")
    return work / (end - start)


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q ≤ 100) of every value, a
    failed request counted as ``inf`` (it misses any limit)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Interval], start: float, end: float
         ) -> List[Interval]:
    return [(max(s, start), min(e, end)) for s, e in intervals
            if e > start and s < end]


def busy(intervals: Iterable[Interval], start: float, end: float) -> float:
    """Time within [start, end] in which some interval runs."""
    return sum(e - s for s, e in merge(clip(intervals, start, end)))


def gaps(intervals: Iterable[Interval], start: float, end: float
         ) -> List[Interval]:
    """The stretches of [start, end] in which no interval runs."""
    out, t = [], start
    for s, e in merge(clip(intervals, start, end)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out


def idle_share(intervals: Iterable[Interval], start: float, end: float
               ) -> float:
    """The share of [start, end] with nothing running, in percent."""
    return 100.0 * (1.0 - busy(intervals, start, end) / (end - start))
