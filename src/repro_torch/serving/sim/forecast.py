"""Demand forecasting for LiveBench (ROADMAP item j, DESIGN.md §12).

``LiveBench``'s trailing per-member demand EWMA answers "what was the mix
*recently*" — under diurnal traffic that is systematically late: by the
time the EWMA has turned, the wave it should have planned for is already
here, and every replan chases the previous half-cycle.  The forecaster
answers "what will the mix be at the *next replan horizon*": it bins
arrivals per member on the submission path, fits a linear trend (Holt
style) to the recent per-member shares, and extrapolates one lead interval
ahead.  The prediction feeds ``LiveBench.set_forecast`` with a TTL — while
fresh it replaces the EWMA in ``demand_shares()``; if the forecaster stops
publishing, the profile falls back to the EWMA that kept updating
underneath (the handoff tested in tests/test_sim.py).

A linear trend is deliberately the whole model: it needs no period
detection, is right about direction exactly where the EWMA is wrong (on
the wave's flanks, where demand is *moving*), and degrades to the EWMA's
behavior on flat traffic.  Seasonal-naive or spectral models slot in by
overriding :meth:`predict_shares`.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["DemandForecaster"]


class DemandForecaster:
    """Windowed per-member arrival-share estimator with linear-trend
    extrapolation.  Single-threaded by design: in-sim it runs on the event
    loop; live it would run on the controller thread."""

    def __init__(self, M: int, *, bin_s: float = 0.25,
                 history_bins: int = 64, trend_bins: int = 4):
        if M < 1 or bin_s <= 0:
            raise ValueError("need M >= 1 members and bin_s > 0")
        self.M = M
        self.bin_s = float(bin_s)
        self.trend_bins = max(2, int(trend_bins))
        self._hist: "deque[np.ndarray]" = deque(maxlen=history_bins)
        self._cur = np.zeros(M, np.float64)
        self._cur_idx: Optional[int] = None
        self._total = np.zeros(M, np.float64)
        self.observations = 0

    def observe(self, t: float, members: Sequence[int], rows: int) -> None:
        """One offered request at time ``t``: ``rows`` rows for each listed
        member.  ``t`` must be non-decreasing (arrival order)."""
        idx = int(t / self.bin_s)
        if self._cur_idx is None:
            self._cur_idx = idx
        while idx > self._cur_idx:             # close bins, zero-fill gaps
            self._hist.append(self._cur)
            self._cur = np.zeros(self.M, np.float64)
            self._cur_idx += 1
        for m in members:
            self._cur[m] += rows
            self._total[m] += rows
        self.observations += 1

    def _recent_shares(self) -> List[np.ndarray]:
        bins = [b for b in list(self._hist)[-self.trend_bins:]
                if b.sum() > 0]
        return [b / b.sum() for b in bins]

    def predict_shares(self, lead_s: float) -> np.ndarray:
        """Predicted demand shares ``lead_s`` seconds past the last closed
        bin.  With fewer than 2 informative bins this is the cumulative
        observed share (uniform when nothing was observed) — i.e. the
        forecaster never does worse than a long-run average while cold."""
        shares = self._recent_shares()
        if not shares:
            tot = self._total.sum()
            if tot <= 0:
                return np.full(self.M, 1.0 / self.M)
            return self._total / tot
        if len(shares) == 1:
            return shares[0].copy()
        S = np.stack(shares)                   # (k, M) bin shares
        k = S.shape[0]
        x = np.arange(k, dtype=np.float64)     # bin midpoints, bin units
        xm = x.mean()
        denom = ((x - xm) ** 2).sum()
        slope = ((x - xm)[:, None] * (S - S.mean(0))).sum(0) / denom
        # extrapolate from the last bin's midpoint to the lead horizon
        steps = 0.5 + lead_s / self.bin_s
        pred = S[-1] + slope * steps
        pred = np.clip(pred, 1e-3, None)
        return pred / pred.sum()

    def feed(self, live, *, lead_s: float, ttl_s: float) -> np.ndarray:
        """Publish the current prediction into a ``LiveBench``: the replan
        tick calls this right before scoring so the greedy plans against
        where demand is *going*."""
        shares = self.predict_shares(lead_s)
        live.set_forecast(shares, ttl_s=ttl_s)
        return shares
