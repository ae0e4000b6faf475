"""Arithmetic of the metrics: rates over a window, percentiles and the
union of device intervals."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple


def rate(t0: float, completions: Sequence[float]) -> Optional[float]:
    """Completions per second from ``t0`` to the last of them: every
    completion counts one, so a completion cut off by the window's end
    changes nothing."""
    done = [t for t in completions if t >= t0]
    if not done or max(done) <= t0:
        return None
    return len(done) / (max(done) - t0)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100), linear between order statistics."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [start, end) covered by no interval."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
