"""The discrete-event model of the serving pipeline (DESIGN.md §12).

One :class:`SimWorker` mirrors the live ``Worker``'s three stages under a
virtual clock:

* **batcher** — the exact packing rules of ``Worker._admit``/``_flush``:
  ring-slot backpressure (``RING_SLOTS`` free-slot accounting, bulk work
  stalls on an exhausted ring while express high-priority packing draws
  side buffers), span cutting at compiled-batch boundaries, linger with
  deadline-aware collapse, ``bucket_for`` shape bucketing, refcounted
  ``SlotRef`` recycling — producing real ``ChunkDesc`` objects on a real
  ``DispatchQueue`` (or the EDF prototype).
* **predictor** — the dispatch-ahead group pop: up to K chunks leave the
  queue together, serve sequentially at :class:`ServiceModel` times plus a
  per-group dispatch overhead, with drop-at-dequeue for fully
  expired/demoted chunks.
* **completion** — spans credit their requests (the combiner's row-count
  accounting collapsed to per-span arithmetic: a request completes when
  every (segment × member) row is accounted), feeding the same
  ``StageTimers`` latency/counter surface the live system exports.

:class:`SimSystem` duck-types the ``InferenceSystem`` attribute surface the
control plane touches (``workers``, ``_instances``, ``_submit_lock``,
``timers``, ``accumulator``, ``latency_snapshot``, ``demote_request``,
``segment_size``, ``M``, ``alloc``), so the *real* policy code runs
unmodified in-sim: ``balance_member`` steals between siblings,
``BrownoutController.step`` runs its actual control law, ``LiveBench`` is
fed real ``observe``/``note_request`` calls (on virtual time, via its
``clock`` hook), and ``bounded_greedy`` replans real ``AllocationMatrix``
objects which :meth:`SimSystem.apply_alloc` applies as spawn/drain/rebatch
actions.

What is *not* modelled: payload bytes (shape-only), kernel build time,
host↔device transfer overlap, and thread scheduling jitter — service time
is the model.  Fidelity against real ``fake_delay_us`` runs is asserted by
the JAX package's gated `sim_fidelity` bench scenario; on the card,
``chip_smoke.py``'s ``sim:qwen3`` phase records simulated against measured
req/s and latency for a ``LiveBench``-fitted model.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.admission import (AdmissionQueue, DispatchQueue,
                                          chunk_level)
from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.segments import (PRIORITY_HIGH, PRIORITY_NORMAL,
                                          ChunkDesc, FlushBarrier, Overloaded,
                                          PredictOptions, SlotRef, Span)
from repro_torch.serving.sim.events import EventLoop
from repro_torch.serving.sim.service import ServiceModel
from repro_torch.serving.trace import TraceEvent
from repro_torch.serving.tracing import Tracer
from repro_torch.serving.worker import (ADAPTIVE_DEPTH, DISPATCH_AHEAD,
                                        RING_SLOTS, _span_rids, bucket_for)

__all__ = ["SimSystem", "SimWorker", "WorkerSpec", "SimRequest"]

_INF = float("inf")


class SimRequest:
    """Light stand-in for ``segments.Request`` carrying exactly the fields
    the real queue/steal/chunk/brownout code reads (``priority``,
    ``deadline``, ``members``, ``demoted``, ``dropped()``,
    ``demoted_for()``, ``bounds()``) — expiry checks run against the
    virtual clock instead of ``time.perf_counter``."""

    __slots__ = ("rid", "n", "members", "priority", "deadline", "t_arrival",
                 "segment_size", "remaining", "demoted", "failed", "t_done",
                 "_loop")

    def __init__(self, rid: int, n: int, members: Sequence[int],
                 priority: int, deadline: Optional[float], t_arrival: float,
                 segment_size: int, loop: EventLoop):
        self.rid = rid
        self.n = n
        self.members = list(members)
        self.priority = priority
        self.deadline = deadline       # absolute virtual seconds, or None
        self.t_arrival = t_arrival
        self.segment_size = segment_size
        self.remaining = n * len(members)
        self.demoted: set = set()
        self.failed = False
        self.t_done: Optional[float] = None
        self._loop = loop

    @property
    def req(self):                      # accumulator-handle view (h.req)
        return self

    def num_segments(self) -> int:
        return -(-self.n // self.segment_size)

    def bounds(self, s: int) -> Tuple[int, int]:
        lo = s * self.segment_size
        return lo, min(self.n, lo + self.segment_size)

    def dropped(self) -> bool:
        return self.failed or (self.deadline is not None
                               and self._loop.now > self.deadline)

    def demoted_for(self, m: int) -> bool:
        return m in self.demoted


@dataclass(frozen=True)
class WorkerSpec:
    """One sim worker: which member it serves, at what batch size, on which
    device key, at what relative speed (service times are multiplied by
    ``1/speed`` — 2.0 = twice as fast as the fitted model)."""
    model_idx: int
    batch_size: int
    device_key: str = ""
    speed: float = 1.0


class _SimDevice:
    """Minimal stand-in for ``DeviceSpec`` where only ``key()`` is read
    (LiveBench observation keys, balance_member profile lookups)."""
    __slots__ = ("_key",)

    def __init__(self, key: str):
        self._key = key

    def key(self) -> str:
        return self._key


class _SimOpen:
    """The batcher's in-progress coalesced slot (mirror of ``_OpenBatch``,
    minus the buffer — only fill accounting and spans matter here)."""
    __slots__ = ("ring", "fill", "spans", "deadline", "oid", "armed_at")

    def __init__(self, ring: bool, deadline: float, oid: int):
        self.ring = ring               # consumes a ring slot (vs side pool)
        self.fill = 0
        self.spans: List[Span] = []
        self.deadline = deadline
        self.oid = oid
        self.armed_at = _INF           # earliest linger event scheduled


class SimWorker:
    """Virtual-clock model of one worker instance.  Exposes the attribute
    surface the control plane prices workers by (``input_queue``,
    ``dispatch_backlog()``, ``chunks_per_segment``, ``batch_size``,
    ``segment_size``, ``device.key()``, ``fake_delay_us``, ``model_idx``,
    ``combiner``) so ``estimate_drain_s`` / ``balance_member`` /
    ``BrownoutController`` run against it unmodified."""

    def __init__(self, system: "SimSystem", worker_id: str, model_idx: int,
                 batch_size: int, *, device_key: str = "", speed: float = 1.0,
                 generation: int = 0):
        self.system = system
        self.worker_id = worker_id
        self.model_idx = model_idx
        self.batch_size = int(batch_size)
        self.segment_size = system.segment_size
        self.device = _SimDevice(device_key or f"sim:{worker_id}")
        self.device_idx: Optional[int] = None
        self.speed = float(speed)
        self.generation = generation
        self.combiner = None           # span credits replace row-count maps
        self.input_queue = AdmissionQueue()
        self._dispatch_q = system.queue_cls()
        self.timers = system.timers
        chunks_per_seg = max(1, -(-self.segment_size // self.batch_size))
        self._span = chunks_per_seg * self.batch_size
        self.dispatch_ahead = system.dispatch_ahead
        self.coalesce = system.coalesce
        self.linger_s = system.max_wait_us * 1e-6
        self.linger_mode = system.linger
        svc = system.service
        self.fake_delay_us = svc.fake_delay_us(model_idx, self.batch_size) \
            / self.speed
        self._free = RING_SLOTS
        self.open: Optional[_SimOpen] = None
        self.pending: Optional[tuple] = None   # (req, s, pos) bulk stall
        self.busy = False
        self.retired = False
        self._oid = 0
        # stats the benches read per worker
        self.chunks_done = 0
        self.busy_s = 0.0

    # ---- control-plane surface ----------------------------------------------
    @property
    def chunks_per_segment(self) -> int:
        return self._span // self.batch_size

    def dispatch_backlog(self) -> int:
        return self._dispatch_q.qsize()

    # ---- stage 1: batcher ----------------------------------------------------
    def _effective_linger(self) -> float:
        if self.linger_mode == "adaptive":
            depth = self.input_queue.qsize()
            return self.linger_s * max(0.0, 1.0 - depth / ADAPTIVE_DEPTH)
        return self.linger_s

    def drain(self) -> None:
        """Drain the admission queue into the open slot — the event-driven
        twin of ``Worker._batcher``'s loop body.  Runs at arrival, after a
        steal/migration lands descriptors, and when a recycled ring slot
        unblocks stalled bulk work."""
        loop = self.system.loop
        while True:
            if self.pending is not None:
                if self._free == 0:
                    # bulk stalled on the ring: express-serve queued HIGH
                    # work through side buffers, then wait for a recycle
                    # (the interruptible slot wait of Worker._open_batch)
                    served = False
                    while True:
                        hitem = self.input_queue.take_high()
                        if hitem is None:
                            break
                        served = True
                        self._pack(hitem[0], hitem[1])
                    if served and self.open is not None:
                        self._flush()          # high work never lingers here
                        self._maybe_dispatch()
                    return
                req, s, pos = self.pending
                self.pending = None
                self._pack(req, s, pos)
                continue
            try:
                item = self.input_queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, FlushBarrier):
                if self.open is not None:
                    self._flush()
                self._dispatch_q.put(item)
                self._maybe_dispatch()
                continue
            self._pack(item[0], item[1])
        self._arm_linger()
        self._maybe_dispatch()

    def _pack(self, req: SimRequest, s: int, pos: Optional[int] = None
              ) -> None:
        """``Worker._admit`` under the virtual clock: drop expired, forgive
        demoted, cut the segment into chunk-aligned spans, stall when the
        bulk path runs out of ring slots."""
        sys_ = self.system
        if req.dropped():
            sys_._fail_request(req)
            return
        if req.demoted_for(self.model_idx):
            lo, hi = req.bounds(s)
            self.timers.inc("rows_demoted", hi - lo)
            sys_._credit(req, hi - lo)
            return
        express = req.priority == PRIORITY_HIGH
        lo, hi = req.bounds(s)
        if pos is None:
            pos = lo
        loop = sys_.loop
        while pos < hi:
            if self.open is None and not self._open_new(express):
                self.pending = (req, s, pos)   # resume after a recycle
                return
            b = self.open
            f = b.fill
            fill = min(self._span - f, hi - pos)
            while fill > 0:
                k = min(self.batch_size - f % self.batch_size, fill)
                b.spans.append(Span(req, s, pos - lo, f, k))
                f += k
                pos += k
                fill -= k
            b.fill = f
            if f == self._span:
                self._flush()                  # full slot: flush immediately
        b = self.open
        if b is not None:
            if req.deadline is not None:
                # deadline-aware linger: at most half the tightest packed
                # row's remaining budget (same rule as the live batcher)
                b.deadline = min(b.deadline, (loop.now + req.deadline) / 2.0)
            if express:
                b.deadline = loop.now   # flush once the queue runs dry
            if not self.coalesce:
                self._flush()

    def _open_new(self, express: bool) -> bool:
        if self._free > 0:
            self._free -= 1
            ring = True
        elif express:
            ring = False                       # pooled side buffer
        else:
            return False                       # bulk backpressure
        self._oid += 1
        self.open = _SimOpen(ring, self.system.loop.now
                             + self._effective_linger(), self._oid)
        return True

    def _flush(self) -> None:
        b = self.open
        self.open = None
        if b is None:
            return
        if b.fill == 0:
            if b.ring:
                self._free += 1
            return
        chunks = []
        for off in range(0, b.fill, self.batch_size):
            valid = min(self.batch_size, b.fill - off)
            chunks.append((off, bucket_for(valid, self.batch_size), valid))
            self.timers.inc("rows_valid", valid)
            self.timers.inc("rows_dispatched", chunks[-1][1])
        self.timers.inc("batches", len(chunks))
        self.timers.inc("spans", len(b.spans))
        # ring slots recycle through the refcount, side buffers are free
        ref = SlotRef(0 if b.ring else None, None, len(chunks))
        by_chunk: Dict[int, List[Span]] = {}
        for sp in b.spans:                     # spans are chunk-aligned
            by_chunk.setdefault(sp.batch_off // self.batch_size,
                                []).append(sp)
        now = self.system.loop.now
        by_level: Dict[int, list] = {}
        for i, (off, bucket, valid) in enumerate(chunks):
            spans = by_chunk.get(i, [])
            level = chunk_level(spans)
            by_level.setdefault(level, []).append(
                ChunkDesc(ref, off, bucket, valid, spans, level, now))
        for level, descs in sorted(by_level.items()):
            self._dispatch_q.put_many(descs, level)
        self.system._log("flush", now, self.worker_id, len(chunks), b.fill)
        tr = self.system.tracer
        if tr.enabled:
            tr.ring(f"{self.worker_id}/batcher").append(
                ("i", "pack", now, 0.0,
                 tuple({sp.req.rid for sp in b.spans}),
                 {"chunks": len(chunks), "rows": b.fill}, None, None))

    def _arm_linger(self) -> None:
        b = self.open
        if b is None:
            return
        loop = self.system.loop
        if b.deadline <= loop.now:
            self._flush()
            return
        if b.deadline < b.armed_at:            # deadline moved earlier
            b.armed_at = b.deadline
            loop.schedule(b.deadline, self._linger_fire, b.oid)

    def _linger_fire(self, oid: int) -> None:
        b = self.open
        if b is None or b.oid != oid:
            return                             # already flushed / replaced
        if b.deadline <= self.system.loop.now:
            self._flush()
            self._maybe_dispatch()
        else:                                  # stale event: re-arm
            b.armed_at = _INF
            self._arm_linger()

    # ---- stage 2: predictor --------------------------------------------------
    def _maybe_dispatch(self) -> None:
        """Pop a dispatch-ahead group (up to K chunks) and serve it
        sequentially at model service times — ``Worker._predictor`` with
        the semaphore collapsed to a busy flag (the sim predictor commits
        one group at a time; K bounds the committed, non-preemptible
        window exactly as live)."""
        if self.busy:
            return
        group = []
        while len(group) < self.dispatch_ahead:
            try:
                item = self._dispatch_q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            if isinstance(item, FlushBarrier):
                item.done.set()
                continue
            group.append(item)
        if not group:
            return
        self.busy = True
        loop = self.system.loop
        svc = self.system.service
        # co-located workers time-share their device: a group starts only
        # once the device is free, so workers sharing a device.key() see
        # the same round-robin cycle cost the planners price
        # (core.bench.per_model_throughput) — one worker per key (the
        # default) makes this a no-op
        dev_free = self.system._dev_free
        key = self.device.key()
        t0 = loop.now
        t = max(t0, dev_free.get(key, 0.0)) + svc.dispatch_overhead_s
        tr = self.system.tracer
        tr_ring = tr.ring(f"{self.worker_id}/predict") if tr.enabled else None
        for chunk in group:
            self.timers.add(
                "dispatch_wait.high" if chunk.level == PRIORITY_HIGH
                else "dispatch_wait.normal", loop.now - chunk.t_enq)
            if tr_ring is not None:
                tr_ring.append(
                    ("X", "dispatch_wait", chunk.t_enq,
                     loop.now - chunk.t_enq, _span_rids(chunk.spans),
                     None, None, None))
            live = [sp for sp in chunk.spans
                    if not (sp.req.dropped()
                            or sp.req.demoted_for(self.model_idx))]
            if not live:                       # drop-at-dequeue
                loop.schedule(t, self._complete_chunk, chunk, 0.0)
                continue
            dt = svc.chunk_time(self.model_idx, chunk.bucket) / self.speed
            t += dt
            loop.schedule(t, self._complete_chunk, chunk, dt)
        dev_free[key] = t
        self.busy_s += t - t0
        loop.schedule(t, self._group_done)

    def _complete_chunk(self, chunk: ChunkDesc, dt: float) -> None:
        sys_ = self.system
        if dt > 0.0:
            self.chunks_done += 1
            if sys_.live is not None:
                sys_.live.observe(self.model_idx, self.device.key(),
                                  chunk.bucket, chunk.valid, dt)
        sys_._log("chunk", sys_.loop.now, self.worker_id, chunk.bucket,
                  chunk.valid)
        tr = sys_.tracer
        if tr.enabled and dt > 0.0:
            tr.ring(f"{self.worker_id}/predict").append(
                ("X", "predict", sys_.loop.now - dt, dt,
                 _span_rids(chunk.spans),
                 {"bucket": chunk.bucket, "valid": chunk.valid},
                 None, None))
        for sp in chunk.spans:
            sys_._finish_span(self, sp, serviced=dt > 0.0)
        if chunk.ref.release() and chunk.ref.slot is not None:
            self._free += 1
            if not self.retired:
                self.drain()                   # unstall bulk work

    def _group_done(self) -> None:
        self.busy = False
        self._maybe_dispatch()

    def _drained(self) -> bool:
        return (not self.busy and self.open is None and self.pending is None
                and self.input_queue.qsize() == 0
                and self._dispatch_q.qsize() == 0)


class _SimAccumulator:
    """``PredictionAccumulator`` stand-in: the brownout demotion sweep reads
    ``weights``, ``_lock`` and ``_requests`` (rid → handle with ``.req``);
    SimRequests serve as their own handles."""

    def __init__(self, weights: np.ndarray):
        self.weights = weights
        self._lock = threading.Lock()
        self._requests: Dict[int, SimRequest] = {}


class SimSystem:
    """The simulated serving process: routing, accounting, control hooks.

    Build it either from explicit :class:`WorkerSpec`s (pure-sim studies)
    or :meth:`from_alloc` (an ``AllocationMatrix`` + real devices, so
    ``bounded_greedy`` replans can be applied via :meth:`apply_alloc`).
    Then ``run(trace)`` pumps arrivals and events to completion and
    ``results()`` summarizes — same seed + same trace → bit-identical
    event log and metrics.
    """

    def __init__(self, service: ServiceModel, workers: Sequence[WorkerSpec],
                 *, M: Optional[int] = None, segment_size: int = 64,
                 dispatch_ahead: int = DISPATCH_AHEAD,
                 max_wait_us: float = 500.0, linger: str = "fixed",
                 coalesce: bool = True, queue_cls=DispatchQueue,
                 weights: Optional[Sequence[float]] = None,
                 live=None, record_events: bool = False,
                 tracing: bool = False, trace_capacity: int = 4096):
        self.service = service
        self.segment_size = int(segment_size)
        self.dispatch_ahead = int(dispatch_ahead)
        self.max_wait_us = float(max_wait_us)
        self.linger = linger
        self.coalesce = coalesce
        self.queue_cls = queue_cls
        self.loop = EventLoop()
        self.timers = StageTimers()
        # same span API as the live system, on the virtual clock — a live
        # run and its sim replay export directly comparable timelines
        # (DESIGN.md §13)
        self.tracer = Tracer(enabled=tracing, capacity=trace_capacity,
                             clock=lambda: self.loop.now)
        self.M = M if M is not None else \
            (1 + max(s.model_idx for s in workers))
        self.combine = "mean"
        self.alloc = None                     # set by from_alloc
        self._alloc_devices = None
        self.live = live
        if live is not None:
            live.clock = lambda: self.loop.now   # virtual-time freshness
        self.forecaster = None
        self.brownout = None                  # set by BrownoutController
        self.generation = 0
        self._dev_free: Dict[str, float] = {}   # device.key() -> busy until
        self._submit_lock = threading.Lock()
        w = np.ones(self.M, np.float64) if weights is None \
            else np.asarray(weights, np.float64)
        self.accumulator = _SimAccumulator(w)
        self.workers: List[SimWorker] = []
        self._instances: Dict[int, List[SimWorker]] = {}
        self._retired: List[SimWorker] = []
        self._next_wid = 0
        for spec in workers:
            self._spawn(spec)
        for m in range(self.M):
            if not self._instances.get(m):
                raise ValueError(f"member {m} has no sim worker instance")
        self._next_rid = 0
        self._controls: List[list] = []
        self._arrivals_pending = False
        self.open_requests = 0
        # outcome accounting
        self.offered = 0
        self.completed = 0
        self.completed_rows = 0
        self.failed = 0
        self.shed = 0
        self.deadline_misses_completed = 0
        self.t_first_arrival: Optional[float] = None
        self.t_last_done = 0.0
        self.latencies: Dict[str, List[float]] = {"high": [], "normal": []}
        self.event_log: Optional[List[tuple]] = [] if record_events else None

    # ---- construction --------------------------------------------------------
    @classmethod
    def from_alloc(cls, alloc, service: ServiceModel, *,
                   device_speed: Optional[Sequence[float]] = None,
                   **kw) -> "SimSystem":
        """One sim worker per non-zero ``alloc.A[d, m]`` cell at that batch
        size, keyed by the real device's ``key()`` — the topology the
        replanner's proposals are expressed in."""
        D, M = alloc.A.shape
        specs = []
        for d in range(D):
            for m in range(M):
                if alloc.A[d, m] > 0:
                    specs.append(WorkerSpec(
                        m, int(alloc.A[d, m]),
                        device_key=alloc.devices[d].key(),
                        speed=(device_speed[d] if device_speed is not None
                               else 1.0)))
        sim = cls(service, specs, M=M, **kw)
        sim.alloc = alloc.copy()
        sim._alloc_devices = list(alloc.devices)
        for w in sim.workers:
            for d, dev in enumerate(sim._alloc_devices):
                if dev.key() == w.device.key():
                    w.device_idx = d
                    break
        return sim

    def _spawn(self, spec: WorkerSpec) -> SimWorker:
        wid = f"s{spec.model_idx}.{self._next_wid}"
        self._next_wid += 1
        w = SimWorker(self, wid, spec.model_idx, spec.batch_size,
                      device_key=spec.device_key, speed=spec.speed,
                      generation=self.generation)
        self.workers.append(w)
        self._instances.setdefault(spec.model_idx, []).append(w)
        return w

    def instances(self, m: int) -> List[SimWorker]:
        return list(self._instances.get(m, ()))

    def latency_snapshot(self):
        return self.timers.latency_snapshot()

    def _log(self, *ev) -> None:
        if self.event_log is not None:
            self.event_log.append(ev)

    # ---- reconfiguration (the replanner's actions) ---------------------------
    def apply_alloc(self, target) -> dict:
        """Apply ``self.alloc -> target`` as instant spawn / drain / rebatch
        actions (live migration latency is below the sim's fidelity floor).
        A retiring worker's queued descriptors migrate to its surviving
        siblings; committed chunks finish on the retiree."""
        if self.alloc is None:
            raise RuntimeError("apply_alloc needs a from_alloc system")
        current = self.alloc
        D, M = current.A.shape
        actions = {"spawns": 0, "drains": 0, "rebatches": 0}
        self.generation += 1
        for d in range(D):
            for m in range(M):
                old, new = int(current.A[d, m]), int(target.A[d, m])
                if old == new:
                    continue
                key = self._alloc_devices[d].key()
                if old > 0:
                    self._retire(m, key)
                    actions["drains" if new == 0 else "rebatches"] += 1
                if new > 0:
                    w = self._spawn(WorkerSpec(m, new, device_key=key))
                    w.device_idx = d
                    if old == 0:
                        actions["spawns"] += 1
        self.alloc = target.copy()
        return actions

    def _retire(self, m: int, device_key: str) -> None:
        inst = self._instances.get(m, [])
        victim = next((w for w in inst if w.device.key() == device_key), None)
        if victim is None:
            return
        inst.remove(victim)
        self.workers.remove(victim)
        victim.retired = True
        self._retired.append(victim)
        # partially-packed bulk remainder finishes locally via a side buffer
        if victim.pending is not None:
            req, s, pos = victim.pending
            victim.pending = None
            victim._free += 1          # grant headroom so _pack cannot stall
            victim._pack(req, s, pos)
            victim._free -= 1
        if victim.open is not None:
            victim._flush()
        descs = victim.input_queue.drain_descriptors()
        targets = self._instances.get(m, [])
        if targets:
            for i, (req, s) in enumerate(descs):
                targets[i % len(targets)].input_queue.put(
                    (req, s), req.priority)
            for w in targets:
                w.drain()
        else:          # transient: re-queue on the retiree until a spawn
            for desc in descs:
                victim.input_queue.put(desc, desc[0].priority)
        victim._maybe_dispatch()

    def demote_request(self, rid: int, keep) -> bool:
        req = self.accumulator._requests.get(rid)
        if req is None or req.priority == PRIORITY_HIGH or req.failed:
            return False
        drop = [m for m in req.members
                if m not in keep and m not in req.demoted]
        if not drop or len(drop) == len(
                [m for m in req.members if m not in req.demoted]):
            return False
        req.demoted.update(drop)
        self.timers.inc("requests_demoted")
        return True

    # ---- control ticks -------------------------------------------------------
    def add_control(self, interval_s: float, fn: Callable[["SimSystem"], None],
                    *, phase_s: Optional[float] = None) -> None:
        """Register a periodic controller (steal pass, brownout step, replan
        tick).  Ticks re-arm only while arrivals or open requests remain,
        so the event loop terminates with the workload."""
        ctl = [float(interval_s), fn]
        self._controls.append(ctl)
        first = interval_s if phase_s is None else phase_s
        self.loop.schedule(self.loop.now + first, self._control_tick, ctl)

    def _control_tick(self, ctl: list) -> None:
        interval, fn = ctl
        fn(self)
        if self._arrivals_pending or self.open_requests > 0:
            self.loop.schedule(self.loop.now + interval,
                               self._control_tick, ctl)

    def attach_balancer(self, interval_s: float = 0.002, *,
                        threshold: int = 4, max_items: int = 32) -> None:
        """The real work stealer on a virtual cadence: ``balance_member``
        per member, draining the receiving workers afterwards (real queues
        don't notify the sim loop)."""
        from repro_torch.serving.control.stealing import balance_member

        def _tick(sys_: "SimSystem") -> None:
            for m in range(sys_.M):
                moved = balance_member(sys_, m, threshold=threshold,
                                       max_items=max_items,
                                       profile=sys_.live)
                if moved:
                    sys_.timers.inc("steals")
                    sys_.timers.inc("stolen", moved)
                    for w in sys_._instances.get(m, ()):
                        w.drain()

        self.add_control(interval_s, _tick)

    # ---- submission ----------------------------------------------------------
    def _submit(self, ev: TraceEvent) -> None:
        loop = self.loop
        now = loop.now
        members = list(ev.members) if ev.members is not None \
            else list(range(self.M))
        pri = PRIORITY_HIGH if ev.priority == "high" else PRIORITY_NORMAL
        self.offered += 1
        if self.t_first_arrival is None:
            self.t_first_arrival = now
        if self.forecaster is not None:
            self.forecaster.observe(now, members, ev.rows)
        if self.brownout is not None:
            opts = PredictOptions(
                priority=ev.priority, deadline_ms=ev.deadline_ms,
                members=members)
            try:
                self.brownout.check_admission(ev.rows, members, opts)
            except Overloaded:
                self.shed += 1
                self._log("shed", now, self._next_rid)
                self._next_rid += 1
                return
            members, _q = self.brownout.plan_members(members, opts)
        if self.live is not None:
            self.live.note_request(members, ev.rows)
        rid = self._next_rid
        self._next_rid += 1
        deadline = None if ev.deadline_ms is None \
            else now + ev.deadline_ms * 1e-3
        req = SimRequest(rid, ev.rows, members, pri, deadline, now,
                         self.segment_size, loop)
        self.accumulator._requests[rid] = req
        self.open_requests += 1
        self._log("arrive", now, rid, ev.rows, pri)
        if self.tracer.enabled:
            # admission is instantaneous in virtual time: a zero-duration
            # root span keeps the live timeline's shape
            self.tracer.ring("admission").append(
                ("X", "submit", now, 0.0, rid,
                 {"priority": pri, "members": list(members),
                  "rows": ev.rows}, None, None))
        touched: Dict[SimWorker, None] = {}
        for s in range(req.num_segments()):
            for m in members:
                inst = self._instances[m]
                w = inst[(s + rid) % len(inst)]
                w.input_queue.put((req, s), pri)
                touched[w] = None
        for w in touched:
            w.drain()

    # ---- accounting ----------------------------------------------------------
    def _finish_span(self, worker: SimWorker, sp: Span,
                     serviced: bool) -> None:
        req: SimRequest = sp.req
        if req.failed:
            return
        if not serviced or req.dropped():
            # expired before (or during) service: the live pipeline posts
            # DROPPED, failing the whole request
            self._fail_request(req)
            return
        if req.demoted_for(worker.model_idx):
            self.timers.inc("rows_demoted", sp.n)
        self._credit(req, sp.n)

    def _credit(self, req: SimRequest, rows: int) -> None:
        req.remaining -= rows
        if req.remaining > 0 or req.failed:
            return
        now = self.loop.now
        req.t_done = now
        lat = now - req.t_arrival
        cls = "high" if req.priority == PRIORITY_HIGH else "normal"
        self.timers.latency(cls, lat)
        self.latencies[cls].append(lat)
        self.completed += 1
        self.completed_rows += req.n
        self.open_requests -= 1
        if now > self.t_last_done:
            self.t_last_done = now
        if req.deadline is not None and now > req.deadline:
            self.deadline_misses_completed += 1
            self.timers.inc("deadline_misses")
        self.accumulator._requests.pop(req.rid, None)
        self._log("done", now, req.rid)
        if self.tracer.enabled:
            self.tracer.instant("accumulator", "complete", t=now,
                                rid=req.rid,
                                args={"latency_ms": round(lat * 1e3, 3)})

    def _fail_request(self, req: SimRequest) -> None:
        if req.failed:
            return
        req.failed = True
        self.failed += 1
        self.open_requests -= 1
        self.timers.inc("deadline_misses")
        self.timers.inc("rows_dropped", max(0, req.remaining))
        self.accumulator._requests.pop(req.rid, None)
        self._log("drop", self.loop.now, req.rid)
        if self.tracer.enabled:
            self.tracer.instant("accumulator", "fail", rid=req.rid,
                                args={"error": "DeadlineExceeded"})

    # ---- the run loop --------------------------------------------------------
    def run(self, trace: Sequence[TraceEvent], *,
            until: Optional[float] = None) -> "SimSystem":
        """Replay ``trace`` (sorted by ``t``) to completion.  Arrivals are
        fed from an index pointer rather than pre-scheduled heap events —
        at millions of requests the heap would double event cost.  An
        arrival and an internal event at the same timestamp fire
        arrival-first (deterministic tie-break)."""
        loop = self.loop
        i, n = 0, len(trace)
        self._arrivals_pending = n > 0
        while True:
            if i < n and trace[i].t <= loop.peek():
                t = trace[i].t
                if t > loop.now:
                    loop.now = t
                self._submit(trace[i])
                i += 1
                self._arrivals_pending = i < n
            elif not loop.step():
                break
            if until is not None and loop.now > until:
                break
        return self

    # ---- results -------------------------------------------------------------
    @staticmethod
    def _pctl(vals: List[float], q: float) -> float:
        if not vals:
            return 0.0
        arr = sorted(vals)
        return arr[min(len(arr) - 1, int(q * len(arr)))]

    def results(self) -> dict:
        t0 = self.t_first_arrival or 0.0
        makespan = max(1e-12, self.t_last_done - t0)
        pooled = self.latencies["high"] + self.latencies["normal"]
        out = {
            "offered": self.offered,
            "completed": self.completed,
            "failed": self.failed,
            "shed": self.shed,
            "completed_rows": self.completed_rows,
            "makespan_s": makespan,
            "throughput_rows_per_s": self.completed_rows / makespan,
            "throughput_req_per_s": self.completed / makespan,
            "deadline_misses": self.failed + self.deadline_misses_completed,
            "padding_efficiency": self.timers.padding_efficiency(),
            "p50_ms": 1e3 * self._pctl(pooled, 0.50),
            "p99_ms": 1e3 * self._pctl(pooled, 0.99),
        }
        for cls in ("high", "normal"):
            vals = self.latencies[cls]
            if vals:
                out[f"{cls[0]}p_p50_ms"] = 1e3 * self._pctl(vals, 0.50)
                out[f"{cls[0]}p_p99_ms"] = 1e3 * self._pctl(vals, 0.99)
                out[f"{cls}_n"] = len(vals)
        return out
