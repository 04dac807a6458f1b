"""Per-stage timing counters + serving gauges for the hot path (DESIGN.md §6).

Stages (one wall-clock accumulator each, shared by all threads):
  ``batcher_wait``   time a batcher spends blocked on its input queue,
  ``batch_fill``     copying request rows into coalesced batch slots,
  ``dispatch_wait.high`` / ``dispatch_wait.normal``
                     per-class time a chunk waits in the priority dispatch
                     queue between batcher and predictor (the preemption
                     lever: high should stay near zero under bulk load),
  ``predict``        jitted-step dispatch (async — excludes device time),
  ``transfer``       device sync + device->host fetch in the sender,
  ``combine``        device-partial / accumulator fold time.

Counters (monotonic sums) instrument the coalescing scheduler:
  ``rows_valid``       request rows dispatched to the device,
  ``rows_dispatched``  rows actually sent including bucket padding,
  ``rows_dropped``     rows of cancelled/expired requests dropped before
                       (or instead of) device time,
  ``batches``          compiled-batch dispatches,
  ``spans``            (request, segment, row-range) spans packed into
                       batches — spans/batches is the coalescing factor.

Gauges record last/max/mean of a sampled value (e.g.
``queue_depth.<worker_id>``, that batcher's input-queue backlog at each
drain; ``hp_p50_ms``, the rolling high-priority median request latency).
New gauge keys appear at runtime (a spawn adds ``queue_depth.<id>``), so
first-time insertion and ``gauge_snapshot()`` share a small lock — the
steady-state update path (in-place list mutation, no dict resize) stays
lock-free.

Per-class end-to-end request latency lands in fixed-bucket **log-scale
histograms** (``LATENCY_BOUNDS_S``: 100µs → ~148s at √2 per bucket), not a
bounded reservoir, so p50/p99 cover the whole run instead of the last
window under sustained load.  ``latency_snapshot()`` keeps its
{cls: {n, p50_ms, p99_ms}} shape (percentiles interpolated geometrically
within the matched bucket); ``latency_histogram()`` exposes the raw
buckets, and :func:`prometheus_text` renders the whole surface in
Prometheus text exposition format 0.0.4 for ``GET /metrics?format=prom``.

float += under the GIL is atomic enough for counters; a lock would cost more
than the statistic is worth, so snapshots are only approximately consistent.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

LATENCY_WINDOW = 512      # retained for callers; histograms are unbounded

# log-spaced latency bucket upper bounds (seconds): 1e-4 * sqrt(2)^i.
# 42 finite buckets span 100µs .. ~148s; one overflow bucket above.
LATENCY_BOUNDS_S = tuple(1e-4 * 2.0 ** (i / 2.0) for i in range(42))
_SQRT2 = 2.0 ** 0.5

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _hist_percentile(counts: List[int], n: int, q: float) -> float:
    """Value estimate at quantile ``q`` from per-bucket counts (geometric
    interpolation inside the matched log bucket)."""
    if n <= 0:
        return 0.0
    rank = min(n - 1, int(q * n))
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum > rank:
            if i < len(LATENCY_BOUNDS_S):
                hi = LATENCY_BOUNDS_S[i]
                lo = LATENCY_BOUNDS_S[i - 1] if i else hi / _SQRT2
            else:                       # overflow bucket
                lo = LATENCY_BOUNDS_S[-1]
                hi = lo * _SQRT2
            return (lo * hi) ** 0.5
    return LATENCY_BOUNDS_S[-1]


class StageTimers:
    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, List[float]] = {}   # name -> [last,max,sum,n]
        # new-key insertion resizes the dict, which races snapshot
        # iteration (workers add queue_depth.<id> after a spawn) — guard
        # both with a lock; the common existing-key update stays lock-free
        self._gauge_lock = threading.Lock()
        # latency histograms get a real lock (recording is per-request,
        # not per-chunk, so it is off the hot path): cls -> [counts, sum]
        self._latency: Dict[str, list] = {}
        self._lat_lock = threading.Lock()

    def add(self, stage: str, dt: float) -> None:
        self.total_s[stage] += dt
        self.count[stage] += 1

    def timed(self, stage: str, t0: float) -> float:
        """Record ``now - t0`` under ``stage``; returns now (chains stages)."""
        now = time.perf_counter()
        self.add(stage, now - t0)
        return now

    # ---- counters / gauges ---------------------------------------------------
    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] += v

    def gauge(self, name: str, v: float) -> None:
        g = self._gauges.get(name)
        if g is None:
            with self._gauge_lock:
                g = self._gauges.setdefault(name, [v, v, 0.0, 0])
        g[0] = v
        g[1] = max(g[1], v)
        g[2] += v
        g[3] += 1

    # ---- per-class request latency (SLO view, DESIGN.md §7) ------------------
    def latency(self, cls: str, dt: float) -> None:
        """Record one completed request's end-to-end latency under priority
        class ``cls`` ("high"/"normal").  High-priority completions also
        refresh the ``hp_p50_ms`` gauge, so the rolling median is visible
        wherever gauges are (the bucket walk is O(buckets), off the bulk
        path)."""
        i = 0
        bounds = LATENCY_BOUNDS_S
        lo, hi = 0, len(bounds)
        while lo < hi:                  # first bound >= dt (bisect)
            mid = (lo + hi) // 2
            if bounds[mid] < dt:
                lo = mid + 1
            else:
                hi = mid
        i = lo                          # == len(bounds) -> overflow bucket
        with self._lat_lock:
            h = self._latency.get(cls)
            if h is None:
                h = self._latency[cls] = [[0] * (len(bounds) + 1), 0.0]
            h[0][i] += 1
            h[1] += dt
            if cls == "high":
                n = sum(h[0])
                self.gauge("hp_p50_ms",
                           1e3 * _hist_percentile(h[0], n, 0.50))

    def latency_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-class {p50_ms, p99_ms, n} over the full run (histogram
        estimate — same shape the reservoir version exported)."""
        out = {}
        with self._lat_lock:
            classes = {cls: ([*h[0]], h[1]) for cls, h in
                       self._latency.items()}
        for cls, (counts, _total) in sorted(classes.items()):
            n = sum(counts)
            if not n:
                continue
            out[cls] = {"n": n,
                        "p50_ms": 1e3 * _hist_percentile(counts, n, 0.50),
                        "p99_ms": 1e3 * _hist_percentile(counts, n, 0.99)}
        return out

    def latency_histogram(self) -> Dict[str, Dict[str, object]]:
        """Raw per-class buckets: {cls: {le_s, counts, sum_s, count}} —
        ``le_s`` upper bounds in seconds, ``counts`` non-cumulative (the
        last entry is the overflow bucket)."""
        with self._lat_lock:
            classes = {cls: ([*h[0]], h[1]) for cls, h in
                       self._latency.items()}
        return {cls: {"le_s": list(LATENCY_BOUNDS_S),
                      "counts": counts,
                      "sum_s": total,
                      "count": sum(counts)}
                for cls, (counts, total) in sorted(classes.items())}

    def padding_efficiency(self) -> float:
        """Valid rows / dispatched rows (1.0 = no padding waste)."""
        dispatched = self.counters.get("rows_dispatched", 0.0)
        if dispatched <= 0:
            return 1.0
        return self.counters.get("rows_valid", 0.0) / dispatched

    def reset(self) -> None:
        self.total_s.clear()
        self.count.clear()
        self.counters.clear()
        with self._gauge_lock:
            self._gauges.clear()
        with self._lat_lock:
            self._latency.clear()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {stage: {"total_s": self.total_s[stage],
                        "count": self.count[stage],
                        "mean_ms": (1e3 * self.total_s[stage] /
                                    max(self.count[stage], 1))}
                for stage in sorted(self.total_s)}

    def counter_snapshot(self) -> Dict[str, float]:
        return dict(self.counters)

    def gauge_snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._gauge_lock:          # vs concurrent first-time inserts
            items = list(self._gauges.items())
        return {name: {"last": g[0], "max": g[1], "mean": g[2] / max(g[3], 1)}
                for name, g in sorted(items)}


# ---- Prometheus text exposition (format 0.0.4) ------------------------------
def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _fmt(v: float) -> str:
    f = float(v)
    return repr(f) if f != int(f) else str(int(f))


def prometheus_text(timers: StageTimers,
                    extra_gauges: Optional[Dict[str, float]] = None) -> str:
    """Render the full metrics surface as Prometheus text exposition:
    counters as ``serving_<name>_total``, stage timers as
    ``serving_stage_seconds_total`` / ``serving_stage_operations_total``
    labeled by stage, per-worker gauges as labeled families
    (``serving_queue_depth{worker=...}``, ``serving_worker_health``),
    scalar gauges as ``serving_<name>``, and per-class latency as a
    cumulative-bucket ``serving_request_latency_seconds`` histogram."""
    lines: List[str] = []

    counters = timers.counter_snapshot()
    for name in sorted(counters):
        m = f"serving_{_prom_name(name)}_total"
        lines.append(f"# HELP {m} Monotonic serving counter {name}.")
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(counters[name])}")

    stages = timers.snapshot()
    if stages:
        lines.append("# HELP serving_stage_seconds_total Wall-clock seconds "
                     "accumulated per pipeline stage.")
        lines.append("# TYPE serving_stage_seconds_total counter")
        for stage in sorted(stages):
            lines.append(f'serving_stage_seconds_total{{stage="{stage}"}} '
                         f'{repr(float(stages[stage]["total_s"]))}')
        lines.append("# HELP serving_stage_operations_total Operations "
                     "timed per pipeline stage.")
        lines.append("# TYPE serving_stage_operations_total counter")
        for stage in sorted(stages):
            lines.append(f'serving_stage_operations_total{{stage="{stage}"}} '
                         f'{_fmt(stages[stage]["count"])}')

    gauges = dict(timers.gauge_snapshot())
    if extra_gauges:
        for name, v in extra_gauges.items():
            gauges.setdefault(name, {"last": float(v)})
    labeled = {"queue_depth": ("serving_queue_depth",
                               "Batcher input-queue backlog per worker."),
               "health": ("serving_worker_health",
                          "Worker health (0 ready / 1 degraded / 2 dead).")}
    emitted_types = set()
    for name in sorted(gauges):
        prefix, _, rest = name.partition(".")
        if rest and prefix in labeled:
            m, help_ = labeled[prefix]
            if m not in emitted_types:
                emitted_types.add(m)
                lines.append(f"# HELP {m} {help_}")
                lines.append(f"# TYPE {m} gauge")
            lines.append(f'{m}{{worker="{rest}"}} '
                         f'{_fmt(gauges[name]["last"])}')
        else:
            m = f"serving_{_prom_name(name)}"
            lines.append(f"# HELP {m} Sampled serving gauge {name} "
                         "(last value).")
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(gauges[name]['last'])}")

    hist = timers.latency_histogram()
    if hist:
        m = "serving_request_latency_seconds"
        lines.append(f"# HELP {m} End-to-end request latency per priority "
                     "class (log-scale buckets).")
        lines.append(f"# TYPE {m} histogram")
        for cls, h in hist.items():
            cum = 0
            for le, c in zip(h["le_s"], h["counts"]):
                cum += c
                lines.append(f'{m}_bucket{{class="{cls}",le="{le:.6g}"}} '
                             f'{cum}')
            cum += h["counts"][-1]
            lines.append(f'{m}_bucket{{class="{cls}",le="+Inf"}} {cum}')
            lines.append(f'{m}_sum{{class="{cls}"}} {repr(float(h["sum_s"]))}')
            lines.append(f'{m}_count{{class="{cls}"}} {h["count"]}')

    return "\n".join(lines) + "\n"
