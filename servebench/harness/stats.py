"""The end-to-end arithmetic: rates over the window, percentiles over every
request."""
from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of every value, interpolated
    linearly between order statistics; an infinite value (a request that
    failed) counts as the slowest."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    if v[hi] == math.inf:
        return math.inf if pos > lo or v[lo] == math.inf else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def completion_rate(start: Iterable[float], done: Iterable[float],
                    rows: Iterable[int], t0: float, t1: float) -> float:
    """Rows a second served in the window [t0, t1]: each answered
    request's rows, in the share of its time from ``start`` (due or sent)
    to its answer that lies inside the window, summed, over t1 - t0.  A
    request inside the window counts whole, one in flight at an edge for
    its part inside, so the rate follows the work and not the phase at
    which whole requests cross the edges.  Time in which nothing is
    answered lowers it, at either edge too: a request that waits across
    t1 for a stall to end has most of its time outside the window."""
    if t1 <= t0:
        raise ValueError("an empty window")
    served = 0.0
    for a, d, r in zip(start, done, rows):
        inside = min(d, t1) - max(a, t0)
        if inside > 0:
            served += r * inside / (d - a)
    return served / (t1 - t0)
