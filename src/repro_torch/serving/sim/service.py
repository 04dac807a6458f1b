"""Per-member chunk service-time models.

The simulator's only free parameters: how long a (member, bucket) chunk
occupies its worker's predictor, plus a fixed per-dispatch-group overhead
(the pop/ship cost the dispatch-ahead window K amortizes).

Two fit paths:

* :meth:`ServiceModel.from_delays` — from known ``fake_delay_us`` settings
  (the fake predictor sleeps a fixed time per chunk regardless of bucket,
  so the model is bucket-flat).
* :meth:`ServiceModel.from_livebench` — from the ``latency_ewma_s`` block
  of a :class:`~repro_torch.serving.control.livebench.LiveBench` snapshot taken
  during a real (simulated-device) run: keys ``m{m}|{dev}|b{bucket}``.
  This is the calibration path the `sim_fidelity` bench gate exercises —
  record a trace + profile from a live run, fit, replay, compare.
  Measured EWMAs already embed dispatch overhead, so fitted models default
  to ``dispatch_overhead_s=0``.

Unknown buckets are priced by nearest-bucket scaling with the same
``OVERHEAD_FLOOR`` rule LiveBench itself uses, so sim and live planner
agree on extrapolated costs.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

from repro_torch.serving.control.livebench import OVERHEAD_FLOOR

__all__ = ["ServiceModel"]

_KEY_RE = re.compile(r"^m(\d+)\|(.+)\|b(\d+)$")


class ServiceModel:
    """Chunk service time in seconds, keyed ``(member, bucket)``."""

    def __init__(self, latency_s: Mapping[Tuple[int, int], float],
                 *, default_s: float = 1e-3,
                 dispatch_overhead_s: float = 0.0):
        self._lat: Dict[Tuple[int, int], float] = {
            (int(m), int(b)): float(s) for (m, b), s in latency_s.items()}
        self._buckets: Dict[int, Tuple[int, ...]] = {}
        for (m, b) in self._lat:
            self._buckets.setdefault(m, ())
        for m in self._buckets:
            self._buckets[m] = tuple(sorted(
                b for (mm, b) in self._lat if mm == m))
        self.default_s = float(default_s)
        self.dispatch_overhead_s = float(dispatch_overhead_s)

    @classmethod
    def from_delays(cls, delays_us: Mapping[int, float], *,
                    dispatch_overhead_s: float = 0.0) -> "ServiceModel":
        """Bucket-flat model from per-member ``fake_delay_us`` settings."""
        lat = {(int(m), 0): float(us) * 1e-6 for m, us in delays_us.items()}
        return cls(lat, dispatch_overhead_s=dispatch_overhead_s)

    @classmethod
    def from_livebench(cls, snapshot: Mapping, *,
                       dispatch_overhead_s: float = 0.0) -> "ServiceModel":
        """Fit from ``LiveBench.snapshot()`` (or the raw ``latency_ewma_s``
        mapping).  Multiple device keys for the same (member, bucket) are
        averaged — the sim routes by member, not device identity."""
        ewma = snapshot.get("latency_ewma_s", snapshot)
        acc: Dict[Tuple[int, int], Tuple[float, int]] = {}
        for key, s in ewma.items():
            mt = _KEY_RE.match(key)
            if not mt:
                continue
            k = (int(mt.group(1)), int(mt.group(3)))
            tot, n = acc.get(k, (0.0, 0))
            acc[k] = (tot + float(s), n + 1)
        if not acc:
            raise ValueError("no latency_ewma_s entries to fit from")
        lat = {k: tot / n for k, (tot, n) in acc.items()}
        return cls(lat, dispatch_overhead_s=dispatch_overhead_s)

    def chunk_time(self, m: int, bucket: int) -> float:
        """Service seconds for one ``bucket``-row chunk of member ``m``.
        Mirrors ``LiveBench._measured_latency``: exact hit, else nearest
        measured bucket scaled by the row ratio with an overhead floor."""
        s = self._lat.get((m, bucket))
        if s is not None:
            return s
        buckets = self._buckets.get(m)
        if not buckets:
            return self.default_s
        b = min(buckets, key=lambda bb: abs(bb - bucket))
        s = self._lat[(m, b)]
        if b <= 0:          # bucket-flat model (from_delays)
            return s
        return s * max(bucket / b, OVERHEAD_FLOOR)

    def members(self) -> Tuple[int, ...]:
        return tuple(sorted(self._buckets))

    def fake_delay_us(self, m: int, batch: int) -> float:
        """Equivalent ``fake_delay_us`` for a full-batch chunk — lets the
        real control plane (``estimate_drain_s``, brownout member costs)
        price sim workers exactly as it prices fake-device workers."""
        return self.chunk_time(m, batch) * 1e6
