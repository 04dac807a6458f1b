"""Overload robustness: brownout levels, cost-aware admission, cascades.

Supervision (DESIGN.md §10) makes the system survive *failures*; this
module makes it survive *success* — sustained offered load beyond capacity
(DESIGN.md §11).  The paper's pipeline degrades by the request under
overload: queues grow, deadlines blow out, callers get 504s.  Here the
system degrades by *quality* instead (ROADMAP direction 2, grounded in
*Flexible DNN Processing*'s incremental-quality inference and *EARN*'s
accuracy/cost Pareto tiers):

* :class:`BrownoutController` folds existing telemetry — admission/dispatch
  queue depths, ``latency_snapshot()`` p99 against a deadline budget,
  deadline-miss and dropped-row rates — into one continuous **pressure**
  signal, and maps it through hysteresis (asymmetric up/down dwell, so the
  level cannot flap at a threshold) to a discrete **brownout level**;

* each level selects a member-subset **quality tier** from a tier table
  ordered by cost-per-unit-weight (level 0 = the full ensemble; each deeper
  tier drops the most expensive remaining member per unit of combine
  weight, with per-member costs taken from the :class:`LiveBench` latency
  EWMA when warm).  New normal-priority requests are *planned* against the
  active tier's subset — reusing the ``PredictOptions.members`` path and
  the missing-weight renormalization of supervision — and their handles
  carry the tier's quality;

* on a level-up, already-admitted requests are **demoted mid-flight**:
  dropped members are added to ``Request.demoted`` and every stage forgives
  (never DROPPED-fails) that member's remaining units — the batcher skips
  packing, the predictor skips dispatching fully-demoted chunks, and the
  sender discards staged rows behind the same in-flight-ledger pop-gate
  that makes quarantine replay idempotent.  The backlog drains at the
  cheap tier instead of timing out;

* admission gains a **feasibility check** (estimated drain + service time
  vs the request's ``deadline_ms``) that fails fast with
  :class:`~repro_torch.serving.segments.Overloaded` — surfaced as HTTP 429 with
  a ``Retry-After`` computed from :func:`estimate_drain_s`, not a
  hardcoded constant;

* an optional **confidence-gated cascade** (:class:`CascadeHandle`)
  escalates an individual request back to the heavier members only when
  the cheap tier's combined output is uncertain (small top1-top2 margin),
  bounding the accuracy loss of serving the cheap tier by default.

Level 0 is a strict no-op on the hot path: ``plan_members`` returns the
caller's member list untouched, so zero-pressure results stay bit-identical
to the pre-brownout engine.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.quant import dtype_bytes as _dtype_bytes
from repro_torch.serving.segments import (Overloaded, PredictOptions,
                                          PRIORITY_HIGH, Request)

# fallback per-segment service time used in drain estimates before any
# latency has been measured (fake workers fold their simulated delay in)
DEFAULT_SEGMENT_S = 1e-3
RETRY_AFTER_FLOOR_S = 0.05


def build_tier_table(weights: Sequence[float],
                     costs: Sequence[float]) -> List[Tuple[int, ...]]:
    """EARN-style accuracy/cost tier table: level 0 keeps every member;
    each deeper level drops the remaining member with the worst
    cost-per-unit-combine-weight (the least accuracy bought per second of
    device time), down to the single cheapest-per-weight member.  Weights
    proxy the accuracy contribution — exactly what the combine uses."""
    members = list(range(len(costs)))
    tiers = [tuple(members)]
    cur = list(members)
    while len(cur) > 1:
        drop = max(cur, key=lambda m: costs[m] / max(float(weights[m]), 1e-12))
        cur = [m for m in cur if m != drop]
        tiers.append(tuple(cur))
    return tiers


def estimate_drain_s(system, live=None, *,
                     default_segment_s: float = DEFAULT_SEGMENT_S,
                     floor_s: float = RETRY_AFTER_FLOOR_S) -> float:
    """Estimated wall time until the deepest worker backlog drains — the
    basis for every ``Retry-After`` this layer emits (429 and 503 alike).
    Backlog is counted in segments (admission queue + dispatch queue /
    chunks-per-segment) and priced by the LiveBench per-segment EWMA when
    warm, falling back to the simulated delay (fake workers) or a flat
    default.  ``floor_s`` keeps client backoff sane; feasibility checks
    pass 0.0 so an idle system never inflates the estimate past a tight
    deadline."""
    worst = 0.0
    for w in list(system.workers):
        backlog = w.input_queue.qsize() + \
            w.dispatch_backlog() / max(1, w.chunks_per_segment)
        if backlog <= 0:
            continue
        t_seg = None
        if live is not None:
            t_seg = live.segment_time(w.model_idx, w.device.key(),
                                      w.batch_size, w.segment_size)
        if t_seg is None:
            per_chunk = max(w.fake_delay_us * 1e-6,
                            default_segment_s / max(1, w.chunks_per_segment))
            t_seg = per_chunk * w.chunks_per_segment
        worst = max(worst, backlog * t_seg)
    return max(floor_s, worst)


class BrownoutController:
    """Maps a continuous pressure signal to discrete brownout levels with
    hysteresis, and applies the active level's quality tier to admission
    and to already-in-flight requests (DESIGN.md §11).

    Pressure is the max of two normalized terms plus a loss term:

    * **queue term** — deepest per-worker backlog (admission + dispatch, in
      segments) over ``depth_ref``;
    * **latency term** — normal-class rolling p99 over
      ``deadline_budget_ms``;
    * **loss term** — 1.0 whenever deadline misses or dropped rows grew
      since the last tick (the system is already failing requests — more
      direct evidence of overload than any queue depth).

    The level steps **up** after ``up_ticks`` consecutive ticks above
    ``high`` and steps **down** only after ``down_ticks`` consecutive
    ticks below ``low`` — with ``low < high`` this is classic dual-band
    hysteresis, so a pressure signal oscillating around either threshold
    cannot flap the tier.

    ``step()`` is the whole control law and takes an optional explicit
    pressure, so tests drive it synchronously; ``start()`` runs it on a
    background thread every ``interval_s``.  Construction attaches the
    controller as ``system.brownout`` — the broadcaster consults it at
    admission."""

    def __init__(self, system, *, live=None,
                 tiers: Optional[Sequence[Sequence[int]]] = None,
                 high: float = 1.0, low: float = 0.4,
                 up_ticks: int = 2, down_ticks: int = 10,
                 interval_s: float = 0.01,
                 depth_ref: float = 16.0,
                 deadline_budget_ms: Optional[float] = None,
                 demote_inflight: bool = True,
                 cascade_margin: Optional[float] = None,
                 feasibility: bool = True):
        if low >= high:
            raise ValueError(f"hysteresis bands must satisfy low < high, "
                             f"got low={low} high={high}")
        self.system = system
        self.live = live if live is not None \
            else getattr(system, "_profiler", None)
        self.high = high
        self.low = low
        self.up_ticks = max(1, up_ticks)
        self.down_ticks = max(1, down_ticks)
        self.interval_s = interval_s
        self.depth_ref = max(1.0, depth_ref)
        self.deadline_budget_ms = deadline_budget_ms
        self.demote_inflight = demote_inflight
        self.cascade_margin = cascade_margin
        self.feasibility = feasibility
        self._tiers = ([tuple(t) for t in tiers] if tiers is not None
                       else None)              # lazily built from live costs
        self._tier_sets: Optional[List[frozenset]] = None
        self._level = 0
        self._above = 0
        self._below = 0
        self._last_loss = 0.0
        self._last_pressure = 0.0
        self.transitions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        system.brownout = self
        system.timers.gauge("brownout_level", 0)

    # ---- tier table ----------------------------------------------------------
    def member_costs(self) -> List[float]:
        """Per-row service-time estimate per member: the cheapest live
        instance's LiveBench per-segment EWMA when warm, the simulated
        delay for fake workers, else a uniform 1.0 (an unmeasured ensemble
        tiers by combine weight alone).  Unmeasured estimates (fake delay /
        uniform fallback) are scaled by the member's param-dtype byte ratio
        (DESIGN.md §14): a memory-bandwidth-bound int8 member streams ~1/4
        the bytes, so quantized members price as the cheap tier and survive
        deepest into a brownout.  Measured EWMAs already embed the speedup
        and are never rescaled."""
        sys_ = self.system
        costs = []
        for m in range(sys_.M):
            best = None
            ratio = 1.0                    # cheapest instance's dtype ratio
            for w in sys_.instances(m):
                ratio = min(ratio, _dtype_bytes(
                    getattr(w, "member_dtype", None)) / 4.0)
                t = None
                if self.live is not None:
                    t = self.live.segment_time(m, w.device.key(),
                                               w.batch_size, w.segment_size)
                if t is None and w.fake_delay_us:
                    t = (w.fake_delay_us * 1e-6 * w.chunks_per_segment
                         * (_dtype_bytes(getattr(w, "member_dtype",
                                                 None)) / 4.0))
                if t is not None:
                    t /= max(1, w.segment_size)
                    best = t if best is None else min(best, t)
            costs.append(best if best is not None else ratio)
        return costs

    def tiers(self) -> List[Tuple[int, ...]]:
        if self._tiers is None:
            self._tiers = build_tier_table(self.system.accumulator.weights,
                                           self.member_costs())
        if self._tier_sets is None or \
                len(self._tier_sets) != len(self._tiers):
            self._tier_sets = [frozenset(t) for t in self._tiers]
        return self._tiers

    def _tier_set(self, level: int) -> frozenset:
        tiers = self.tiers()
        return self._tier_sets[min(level, len(tiers) - 1)]

    # ---- the pressure signal -------------------------------------------------
    def pressure(self) -> float:
        sys_ = self.system
        qp = 0.0
        for w in list(sys_.workers):
            backlog = w.input_queue.qsize() + \
                w.dispatch_backlog() / max(1, w.chunks_per_segment)
            qp = max(qp, backlog / self.depth_ref)
        lp = 0.0
        if self.deadline_budget_ms:
            lat = sys_.latency_snapshot().get("normal", {})
            lp = lat.get("p99_ms", 0.0) / self.deadline_budget_ms
        c = sys_.timers.counter_snapshot()
        loss = c.get("deadline_misses", 0.0) + c.get("rows_dropped", 0.0)
        loss_term = 1.0 if loss > self._last_loss else 0.0
        self._last_loss = loss
        return max(qp, lp) + loss_term

    # ---- the control law -----------------------------------------------------
    def step(self, pressure: Optional[float] = None) -> int:
        """One control tick: fold the pressure through the hysteresis bands
        and apply any level transition.  Returns the (possibly new) level."""
        p = self.pressure() if pressure is None else pressure
        self._last_pressure = p
        if p > self.high:
            self._above += 1
            self._below = 0
        elif p < self.low:
            self._below += 1
            self._above = 0
        else:                         # inside the dead band: hold the level
            self._above = 0
            self._below = 0
        max_level = len(self.tiers()) - 1
        if self._above >= self.up_ticks and self._level < max_level:
            self._above = 0
            self._transition(self._level + 1)
        elif self._below >= self.down_ticks and self._level > 0:
            self._below = 0
            self._transition(self._level - 1)
        return self._level

    @property
    def level(self) -> int:
        return self._level

    def _transition(self, new_level: int) -> None:
        old = self._level
        self._level = new_level
        self.transitions += 1
        self.system.timers.inc("brownout_transitions")
        self.system.timers.gauge("brownout_level", new_level)
        tr = getattr(self.system, "tracer", None)
        if tr is not None:
            # brownout shifts are exactly when a timeline dump is worth
            # keeping: tag the snapshot with the level change
            tr.anomaly("brownout_level_change",
                       f"level {old} -> {new_level}",
                       args={"from": old, "to": new_level})
        if new_level > old and self.demote_inflight:
            self._demote_inflight(self._tier_set(new_level))

    def _demote_inflight(self, keep: frozenset) -> None:
        """On a level-up, demote already-admitted normal-priority requests
        to the new tier so the existing backlog drains at the cheap tier
        instead of timing out at the old one."""
        acc = self.system.accumulator
        with acc._lock:
            handles = list(acc._requests.values())
        for h in handles:
            req = h.req
            if req.priority == PRIORITY_HIGH:
                continue
            self.system.demote_request(req.rid, keep)

    # ---- admission hooks (called by the broadcaster) -------------------------
    def plan_members(self, members: List[int],
                     opts: PredictOptions) -> Tuple[List[int], float]:
        """Intersect a new normal-priority request's member list with the
        active tier; returns ``(planned_members, tier_quality)`` where
        quality is the served fraction of the request's combine weight.
        Level 0 (and high priority, and the 'pallas' combine — its fused
        kernel needs every member) returns the input untouched."""
        lvl = self._level
        if lvl <= 0 or opts.level() == PRIORITY_HIGH or \
                (opts.combine or self.system.combine) == "pallas":
            return members, 1.0
        keep = self._tier_set(lvl)
        kept = [m for m in members if m in keep]
        if not kept or len(kept) == len(members):
            return members, 1.0
        base = self.system.accumulator.weights
        full = float(base[members].sum())
        q = float(base[kept].sum()) / max(full, 1e-12)
        self.system.timers.inc("brownout_planned")
        return kept, min(1.0, q)

    def service_estimate_s(self, n: int, members: Sequence[int]) -> float:
        """Estimated service time for an ``n``-row request over ``members``:
        the slowest member's per-segment time x its segment count, divided
        across its data-parallel instances (striping spreads segments)."""
        sys_ = self.system
        worst = 0.0
        for m in members:
            inst = sys_.instances(m)
            if not inst:
                continue
            segs = -(-n // sys_.segment_size)
            best = None
            for w in inst:
                t = None
                if self.live is not None:
                    t = self.live.segment_time(m, w.device.key(),
                                               w.batch_size, w.segment_size)
                if t is None:
                    per_chunk = max(w.fake_delay_us * 1e-6,
                                    DEFAULT_SEGMENT_S /
                                    max(1, w.chunks_per_segment))
                    t = per_chunk * w.chunks_per_segment
                best = t if best is None else min(best, t)
            worst = max(worst, (best or 0.0) * segs / len(inst))
        return worst

    def drain_estimate_s(self) -> float:
        return estimate_drain_s(self.system, self.live)

    def check_admission(self, n: int, members: Sequence[int],
                        opts: PredictOptions) -> None:
        """Cost-aware feasibility: a deadline the system cannot possibly
        meet at the current backlog fails *now* with
        :class:`Overloaded` (HTTP 429) instead of consuming pipeline
        resources on its way to a 504.  Deadline-less requests always pass
        (the byte/row budget is their only gate)."""
        if not self.feasibility or opts.deadline_ms is None:
            return
        # unfloored: an idle system must not inflate the estimate past a
        # tight-but-feasible deadline (level-0 no-op guarantee)
        drain = estimate_drain_s(self.system, self.live, floor_s=0.0)
        est = drain + self.service_estimate_s(n, members)
        if est > opts.deadline_ms * 1e-3:
            self.system.timers.inc("admission_rejections")
            raise Overloaded(
                f"infeasible at current pressure: estimated "
                f"{est * 1e3:.0f}ms (drain {drain * 1e3:.0f}ms) exceeds "
                f"deadline_ms={opts.deadline_ms:g}",
                retry_after_s=round(max(drain, RETRY_AFTER_FLOOR_S), 3))

    # ---- lifecycle / observability -------------------------------------------
    def start(self) -> "BrownoutController":
        self._thread = threading.Thread(target=self._run, name="brownout",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.step()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def stats(self) -> dict:
        return {"level": self._level,
                "pressure": round(self._last_pressure, 4),
                "transitions": self.transitions,
                "tiers": [list(t) for t in self.tiers()],
                "drain_estimate_s": round(self.drain_estimate_s(), 4)}


class CascadeHandle:
    """Confidence-gated cascade over a tier-planned request (DESIGN.md
    §11).  Duck-types :class:`~repro_torch.serving.accumulator.RequestHandle`:
    ``result()`` first resolves the cheap-tier submission, and only when
    the combined output is *uncertain* (mean top1-top2 margin below the
    threshold) escalates to the members the tier dropped, merging by the
    members' combine-weight fractions — mathematically the full-ensemble
    combine, since each side is a renormalized convex partial sum.

    ``done`` reflects the tier result's readiness (best-effort: a pending
    escalation still blocks inside ``result()``)."""

    def __init__(self, system, inner, escalate: List[int],
                 margin: float, opts: PredictOptions):
        self._system = system
        self._inner = inner
        self._escalate = escalate
        self._margin = margin
        self._opts = opts
        self._resolved: Optional[np.ndarray] = None
        self._quality: Optional[float] = None
        self.req = inner.req
        self.done = inner.done

    @property
    def error(self):
        return self._inner.error

    @property
    def quality(self) -> float:
        if self._quality is not None:
            return self._quality
        return getattr(self._inner, "quality", 1.0)

    def cancel(self) -> bool:
        return self._inner.cancel()

    @staticmethod
    def _mean_margin(Y: np.ndarray) -> float:
        if Y.shape[1] < 2:
            return float("inf")
        part = np.partition(Y, Y.shape[1] - 2, axis=1)
        return float((part[:, -1] - part[:, -2]).mean())

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if self._resolved is not None:
            return self._resolved
        t0 = time.perf_counter()
        Y = self._inner.result(timeout)
        if not self._escalate or self._mean_margin(Y) >= self._margin:
            self._resolved = Y                # confident: cheap tier stands
            self._quality = getattr(self._inner, "quality", 1.0)
            return Y
        # uncertain: escalate to the dropped members, bypassing tier
        # planning (plan=False) so brownout cannot re-demote the escalation
        self._system.timers.inc("cascade_escalations")
        req = self.req
        h2 = self._system._broadcast(np.asarray(req.x[:req.n]),
                                     self._escalate, self._opts, plan=False)
        left = None if timeout is None \
            else max(0.0, timeout - (time.perf_counter() - t0))
        Y2 = h2.result(left)
        base = self._system.accumulator.weights
        kept = [m for m in req.members if m not in req.demoted]
        wk = float(base[kept].sum())
        we = float(base[self._escalate].sum())
        tot = max(wk + we, 1e-12)
        self._resolved = (wk / tot) * Y + (we / tot) * Y2
        # served-weight fraction: the tier already served q1 of the full
        # weight; the escalation restores the dropped share at its own
        # (possibly degraded) quality
        q1 = getattr(self._inner, "quality", 1.0)
        q2 = getattr(h2, "quality", 1.0)
        self._quality = min(1.0, q1 + (we / tot) * q2)
        return self._resolved
