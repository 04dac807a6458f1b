"""Synthetic trace generators: Poisson, bursty (MMPP), diurnal.

All generators take an explicit ``seed`` and return a time-sorted list of
:class:`~repro_torch.serving.trace.TraceEvent` — the same schema recorded live,
so synthetic and recorded traces are interchangeable everywhere.

Request *shapes* (rows / priority / deadline / member subset) are drawn by
a shared :func:`_shape_mix` sampler parameterized per call; arrival *times*
are what distinguish the generators:

* :func:`poisson_trace` — homogeneous Poisson arrivals (exp inter-arrival).
* :func:`mmpp_trace` — 2-state Markov-modulated Poisson process: a calm
  state and a burst state with independent rates and exponential dwell
  times.  The standard bursty-traffic model.
* :func:`diurnal_trace` — inhomogeneous Poisson via thinning, with a
  sinusoidal per-member demand split: member groups wax and wane in
  anti-phase, the pattern the forecaster (DESIGN.md §12) exists to exploit.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.trace import TraceEvent

__all__ = ["poisson_trace", "mmpp_trace", "diurnal_trace"]


def _shape_mix(rng: np.random.Generator, n: int, *, rows, high_fraction: float,
               deadline_ms, members_choices) -> List[Tuple]:
    """Draw n (rows, priority, deadline_ms, members) tuples."""
    if np.isscalar(rows):
        rows_arr = np.full(n, int(rows))
    else:
        rows_arr = rng.choice(np.asarray(rows, dtype=np.int64), size=n)
    high = rng.random(n) < high_fraction
    if members_choices is None:
        midx = None
    else:
        midx = rng.integers(0, len(members_choices), size=n)
    out = []
    for i in range(n):
        members = None if midx is None else members_choices[int(midx[i])]
        out.append((int(rows_arr[i]), "high" if high[i] else "normal",
                    deadline_ms, members))
    return out


def _events(times: np.ndarray, shapes: List[Tuple]) -> List[TraceEvent]:
    return [TraceEvent(t=float(t), rows=r, priority=p, deadline_ms=d,
                       members=m)
            for t, (r, p, d, m) in zip(times, shapes)]


def poisson_trace(n: int, rate: float, *, seed: int, rows=8,
                  high_fraction: float = 0.0,
                  deadline_ms: Optional[float] = None,
                  members_choices: Optional[Sequence[Sequence[int]]] = None,
                  ) -> List[TraceEvent]:
    """``n`` arrivals at ``rate`` requests/s (homogeneous Poisson)."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    shapes = _shape_mix(rng, n, rows=rows, high_fraction=high_fraction,
                        deadline_ms=deadline_ms,
                        members_choices=members_choices)
    return _events(times, shapes)


def mmpp_trace(n: int, *, seed: int, calm_rate: float, burst_rate: float,
               mean_calm_s: float = 1.0, mean_burst_s: float = 0.1,
               rows=8, high_fraction: float = 0.0,
               deadline_ms: Optional[float] = None,
               members_choices: Optional[Sequence[Sequence[int]]] = None,
               ) -> List[TraceEvent]:
    """2-state Markov-modulated Poisson process (bursty arrivals)."""
    rng = np.random.default_rng(seed)
    times = np.empty(n)
    t = 0.0
    burst = False
    state_end = rng.exponential(mean_calm_s)
    for i in range(n):
        while True:
            rate = burst_rate if burst else calm_rate
            dt = rng.exponential(1.0 / rate)
            if t + dt <= state_end:
                t += dt
                break
            # jump to the state boundary and flip; redraw in the new state
            t = state_end
            burst = not burst
            state_end = t + rng.exponential(
                mean_burst_s if burst else mean_calm_s)
        times[i] = t
    shapes = _shape_mix(rng, n, rows=rows, high_fraction=high_fraction,
                        deadline_ms=deadline_ms,
                        members_choices=members_choices)
    return _events(times, shapes)


def diurnal_trace(n: int, *, seed: int, rate: float, period_s: float,
                  amplitude: float = 0.4, members_groups:
                  Sequence[Sequence[int]] = ((0,), (1,)), rows=8,
                  high_fraction: float = 0.0,
                  deadline_ms: Optional[float] = None) -> List[TraceEvent]:
    """Constant total ``rate`` with a sinusoidal demand split across
    ``members_groups``: group 0's share is ``0.5 + amplitude·sin(2πt/P)``,
    group 1's the complement (extra groups split the remainder evenly).
    This is the planner's hard case — total load is steady, so only a
    per-member view (EWMA or forecast) sees the wave coming.
    """
    if not 0.0 < amplitude < 0.5:
        raise ValueError("amplitude must be in (0, 0.5)")
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    u = rng.random(n)
    shapes = _shape_mix(rng, n, rows=rows, high_fraction=high_fraction,
                        deadline_ms=deadline_ms, members_choices=None)
    groups = [tuple(g) for g in members_groups]
    out = []
    for i, t in enumerate(times):
        share0 = 0.5 + amplitude * math.sin(2.0 * math.pi * t / period_s)
        if u[i] < share0 or len(groups) == 1:
            g = groups[0]
        elif len(groups) == 2:
            g = groups[1]
        else:
            rest = (u[i] - share0) / max(1e-12, 1.0 - share0)
            g = groups[1 + min(len(groups) - 2,
                               int(rest * (len(groups) - 1)))]
        rows_i, pri, dl, _ = shapes[i]
        out.append(TraceEvent(t=float(t), rows=rows_i, priority=pri,
                              deadline_ms=dl, members=g))
    return out
