"""Statistics of a run: percentiles and the union of time intervals."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= reach:
            continue
        total += e - max(s, reach)
        reach = e
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of ``[start, end]`` that no interval covers."""
    out, reach = [], start
    for s, e in sorted(intervals):
        if s > reach:
            out.append((reach, min(s, end)))
        reach = max(reach, e)
        if reach >= end:
            break
    if reach < end:
        out.append((reach, end))
    return [(s, e) for s, e in out if e > s]
