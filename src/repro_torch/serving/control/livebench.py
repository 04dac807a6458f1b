"""The online bench: a live ``bench(A) -> score`` for the replanner.

The paper's allocator scores matrices with an *offline* bench — either the
40-second Benchmark-Mode measurement or the roofline ``AnalyticBench`` — on a
calibration workload fixed before deployment.  At runtime the real workload
drifts: members run hotter or colder than the bench profile assumed, and the
measured per-worker latencies embed effects no roofline captures (GIL
contention, co-location interference, cache behavior).  ``LiveBench`` keeps
two continuously-updated views (DESIGN.md §8):

* a **latency profile** — an EWMA of per-batch wall time keyed by
  ``(member, device key, compiled bucket)``, fed by every worker's sender
  (dispatch-to-materialized, attributed to chunks by dispatched rows);
* **demand shares** — a decayed per-member row count fed by the
  broadcaster, so ensemble-selection traffic (``members=[...]`` subsets)
  shows up as per-member load skew.

Called as a ``Bench`` it mirrors ``AnalyticBench``'s structure — co-located
workers time-share their device, a model's throughput adds over instances —
but uses measured latencies where available (falling back to the roofline
for never-observed placements) and weights the final min by demand shares:
a member carrying 4x the traffic needs 4x the throughput before it stops
being the bottleneck.  Scores stay comparable across candidates, which is
all the bounded greedy needs.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memory as mem
from repro_torch.core.allocation import AllocationMatrix
from repro_torch.core.bench import AnalyticBench, per_model_throughput
from repro_torch.core.devices import DeviceSpec

# below this fraction of a measured bucket, extrapolated latency stops
# shrinking: per-batch dispatch overhead puts a floor under small buckets
OVERHEAD_FLOOR = 0.25


class LiveBench:
    """EWMA latency/demand profile over the serving hot path, callable as a
    ``Bench``.  ``observe``/``note_request`` are called from worker sender
    threads and the broadcaster; scoring runs on the controller thread —
    all state is guarded by one lock (the critical sections are tiny)."""

    def __init__(self, cfgs: Sequence[ModelConfig], *, seq: int = 128,
                 alpha: float = 0.25, demand_decay: float = 0.999,
                 dtype_bytes: int = 4,
                 fallback: Optional[AnalyticBench] = None,
                 member_dtypes: Optional[Sequence[Optional[str]]] = None):
        self.cfgs = list(cfgs)
        self.seq = seq
        self.alpha = alpha
        self.demand_decay = demand_decay
        self.dtype_bytes = dtype_bytes
        # per-member execution dtype (DESIGN.md §14): quantized members'
        # smaller param footprint feeds fit_mem and the roofline fallback
        self.member_dtypes = list(member_dtypes) if member_dtypes else None
        self.fallback = fallback or AnalyticBench(
            cfgs, seq=seq, dtype_bytes=dtype_bytes,
            member_dtypes=member_dtypes)
        self._lock = threading.Lock()
        self._lat: Dict[Tuple[int, str, int], float] = {}
        # uniform prior: demand shares start equal and drift with traffic
        self._demand = np.ones(len(self.cfgs), np.float64)
        # forecast-fed shares (DESIGN.md §12): (shares, expires_at) or None.
        # ``clock`` is overridable so the simulator can expire forecasts on
        # virtual time; everything else in this class is time-free.
        self._forecast: Optional[Tuple[np.ndarray, float]] = None
        self.forecasts = 0
        self.clock = time.perf_counter
        self.observations = 0
        self.requests = 0
        self.calls = 0

    # ---- the feeds (hot path) ------------------------------------------------
    def observe(self, m: int, dev_key: str, bucket: int, rows: int,
                dt: float) -> None:
        """One compiled-batch completion: ``rows`` valid rows of member ``m``
        ran in a ``bucket``-row batch on the device in ``dt`` seconds."""
        if rows <= 0 or dt <= 0.0:
            return
        key = (m, dev_key, int(bucket))
        with self._lock:
            old = self._lat.get(key)
            self._lat[key] = dt if old is None else \
                (1.0 - self.alpha) * old + self.alpha * dt
            self.observations += 1

    def note_request(self, members: Sequence[int], rows: int) -> None:
        """One admitted request: ``rows`` rows for each member in the
        request's (possibly subset) member list."""
        with self._lock:
            self.requests += 1
            self._demand *= self.demand_decay
            for m in members:
                self._demand[m] += rows

    def set_forecast(self, shares: Sequence[float], *,
                     ttl_s: float = 5.0) -> None:
        """Install predicted per-member demand shares (item j).  While the
        forecast is *fresh* (within ``ttl_s`` of ``self.clock()``) it
        replaces the trailing EWMA in :meth:`demand_shares`; once stale the
        profile falls back to the decayed EWMA, which kept updating the
        whole time — a dead forecaster degrades to pre-forecast behavior
        rather than freezing the planner on an old prediction."""
        s = np.asarray(shares, np.float64)
        if s.shape != (len(self.cfgs),) or (s < 0).any() or s.sum() <= 0:
            raise ValueError(f"forecast shares must be {len(self.cfgs)} "
                             f"non-negative values, got {shares!r}")
        with self._lock:
            self._forecast = (s / s.sum(), self.clock() + float(ttl_s))
            self.forecasts += 1

    def forecast_fresh(self) -> bool:
        with self._lock:
            return (self._forecast is not None
                    and self.clock() < self._forecast[1])

    # ---- the profile ---------------------------------------------------------
    def demand_shares(self) -> np.ndarray:
        with self._lock:
            if self._forecast is not None:
                shares, expires = self._forecast
                if self.clock() < expires:
                    return shares.copy()
                self._forecast = None       # stale: drop, fall back to EWMA
            d = self._demand.copy()
        return d / d.sum()

    def _measured_latency(self, m: int, dev_key: str,
                          bucket: int) -> Optional[float]:
        """Measured per-batch latency estimate for (member, device, bucket):
        the exact EWMA, else the nearest measured bucket scaled by the batch
        ratio with an overhead floor (per-batch dispatch cost puts a floor
        under small buckets).  None when this (member, device) was never
        observed."""
        with self._lock:
            dt = self._lat.get((m, dev_key, bucket))
            if dt is not None:
                return dt
            near = [(abs(b - bucket), b, t) for (mm, kk, b), t
                    in self._lat.items() if mm == m and kk == dev_key]
        if not near:
            return None
        _, b, t = min(near)
        return t * max(bucket / b, OVERHEAD_FLOOR)

    def segment_time(self, m: int, dev_key: str, batch: int,
                     segment_size: int) -> Optional[float]:
        """Estimated wall time for one ``segment_size``-row segment of
        member ``m`` on a ``batch``-sized worker: measured per-chunk EWMA x
        chunks per segment.  Returns None when nothing relevant was measured
        yet — the caller (the work stealer) then treats siblings as
        equal-rate instead of trusting the roofline."""
        per_chunk = self._measured_latency(m, dev_key, batch)
        if per_chunk is None:
            return None
        return per_chunk * max(1, -(-segment_size // batch))

    def worker_time(self, dev: DeviceSpec, m: int, bucket: int) -> float:
        """Expected per-batch latency for (member, device, bucket): the
        measured estimate when available, the roofline fallback for
        never-observed placements."""
        dt = self._measured_latency(m, dev.key(), bucket)
        if dt is not None:
            return dt
        return self.fallback.worker_time(
            dev, self.cfgs[m], bucket,
            self.member_dtypes[m] if self.member_dtypes else None)

    # ---- the Bench -----------------------------------------------------------
    def __call__(self, alloc: AllocationMatrix) -> float:
        """Demand-weighted live throughput estimate of matrix ``alloc`` (same
        0.0-for-infeasible convention as the offline benches).  Uniform
        demand reduces to ``AnalyticBench``'s plain min-over-members."""
        self.calls += 1
        if not alloc.is_valid():
            return 0.0
        if not mem.fit_mem(alloc, self.cfgs, self.seq, self.dtype_bytes,
                           member_dtypes=self.member_dtypes):
            return 0.0
        per_model = per_model_throughput(
            alloc, lambda d, m, b: self.worker_time(alloc.devices[d], m, b))
        shares = self.demand_shares() * len(self.cfgs)
        return min(thr / shares[m] for m, thr in enumerate(per_model))

    def snapshot(self) -> dict:
        """Observability view for ``/metrics`` (DESIGN.md §8)."""
        with self._lock:
            lat = {f"m{m}|{k}|b{b}": round(t, 6)
                   for (m, k, b), t in sorted(self._lat.items())}
        return {"observations": self.observations,
                "requests": self.requests,
                "bench_calls": self.calls,
                "forecasts": self.forecasts,
                "forecast_fresh": self.forecast_fresh(),
                "demand_shares": [round(float(s), 4)
                                  for s in self.demand_shares()],
                "latency_ewma_s": lat}
