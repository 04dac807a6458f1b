"""The inference system core (paper §II.C): ``f(X, A) -> {Y, S}``.

"Deploy Mode": ``predict(X) -> Y`` serves requests.
"Benchmark Mode": ``benchmark(X) -> (Y, S)`` measures the throughput S of
allocation matrix A on calibration samples.

Processes (threads here — DESIGN.md §2): the *segment ids broadcaster*, the
*worker pool* and the *prediction accumulator*, wired by thread-safe FIFO
queues; sample bytes live in per-request input buffers, only small segment
descriptors travel through queues.

Hot-path architecture (DESIGN.md §§3-5), as in the JAX package:
  * every request owns a pooled input buffer (versioned swap — growing a
    later request can never invalidate a buffer workers still read);
  * (segment, model) pairs are striped round-robin across a model's
    data-parallel instances, which makes per-device contribution counts
    deterministic and enables the device-resident partial combine
    (``device_combine=True``): one accumulator message per device per
    segment instead of one per member per segment — striping is unchanged
    under coalescing, so row-count flush accounting still closes;
  * requests are tagged with ids and pipelined — up to ``max_in_flight``
    ``predict_async()`` calls overlap instead of serializing on the
    accumulator.  The window defaults to 16 so the coalescing batchers
    (``coalesce=True``, bounded ``max_wait_us`` linger) see rows from many
    small concurrent requests and can pack them into full compiled batches;
    ``quiesce()`` force-flushes any lingering partial batches.

The port serves cross-attention members too (``frontends``: member index ->
(batch, F, fdim) embeddings, held on the member's device; zeros where a
member has none).  The control plane is the JAX package's: supervision with
quarantine and replay, live spawn/drain/steal (``serving.control``),
brownout, the admission budget and the request-trace recorder.  On the card,
``drain_instance(wait=True)`` also drops the drained worker's device tensors
once its threads have exited, so its memory returns to the allocator even
while a caller still holds the ``Worker``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocation import AllocationMatrix
from repro_torch.serving.accumulator import PredictionAccumulator, RequestHandle
from repro_torch.serving.admission import AdmissionBudget, AdmissionQueue
from repro_torch.serving.combiner import DeviceCombiner
from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.segments import (
    DEFAULT_SEGMENT_SIZE, FLUSH, OOM, FlushBarrier, SHUTDOWN, DeadlineExceeded,
    MemberUnavailable, Message, Overloaded, PredictOptions, Request,
    RetriesExhausted)
from repro_torch.serving.worker import HEALTH_DEAD, Worker

_COMBINE_RULES = ("mean", "weighted", "vote", "pallas")


class InferenceSystem:
    def __init__(self, cfgs: Sequence[ModelConfig], params_list,
                 alloc: AllocationMatrix, *,
                 segment_size: int = DEFAULT_SEGMENT_SIZE,
                 combine: str = "mean",
                 weights: Optional[np.ndarray] = None,
                 fake: bool = False,
                 frontends: Optional[Dict[int, np.ndarray]] = None,
                 max_seq: int = 128,
                 use_kernel: bool = False,
                 ready_timeout: float = 300.0,
                 device_combine: bool = True,
                 max_in_flight: int = 16,
                 coalesce: bool = True,
                 max_wait_us: int = 500,
                 linger: str = "fixed",
                 fake_delay_us: int = 0,
                 dispatch_ahead: Optional[int] = None,
                 fault_plan=None,
                 supervise: bool = False,
                 watchdog_s: float = 5.0,
                 supervise_interval_s: float = 0.05,
                 retry_budget: int = 2,
                 nan_guard: bool = False,
                 admission_budget=None,
                 tracing: bool = False,
                 trace_capacity: int = 4096,
                 member_dtypes: Optional[Sequence[Optional[str]]] = None,
                 dispatch_queue: str = "fifo"):
        alloc.validate()
        self.cfgs = list(cfgs)
        self.alloc = alloc
        self.segment_size = segment_size
        self.max_seq = max_seq
        self.combine = combine
        self.device_combine = device_combine
        self.max_in_flight = max(1, max_in_flight)
        self.coalesce = coalesce
        self.max_wait_us = max_wait_us
        self.linger = linger
        # K outstanding async dispatches per worker: the committed
        # (non-preemptible) window — small K favors high-priority latency,
        # large K favors pipeline throughput (DESIGN.md §3)
        from repro_torch.serving.worker import DISPATCH_AHEAD
        self.dispatch_ahead = DISPATCH_AHEAD if dispatch_ahead is None \
            else dispatch_ahead
        self.M = len(self.cfgs)
        # per-member execution precision (DESIGN.md §14): "fp32" (default),
        # "bf16", "int8" or "fp8".  Quantized members load per-channel-scaled
        # narrow params, emit (q, scale) logits into the fused combine
        # epilogue, and halve-to-quarter their allocator footprint.
        from repro_torch.kernels.quant import validate_member_dtype
        if member_dtypes is None:
            self.member_dtypes: List[str] = ["fp32"] * self.M
        else:
            if len(member_dtypes) != self.M:
                raise ValueError(
                    f"member_dtypes needs {self.M} entries, "
                    f"got {len(member_dtypes)}")
            self.member_dtypes = [validate_member_dtype(dt or "fp32")
                                  for dt in member_dtypes]
        # dispatch-queue policy (ROADMAP item m): FIFO-within-priority
        # (default) or earliest-deadline-first, simulator-validated
        if dispatch_queue not in ("fifo", "edf"):
            raise ValueError(f"dispatch_queue must be 'fifo' or 'edf', "
                             f"got {dispatch_queue!r}")
        self.dispatch_queue = dispatch_queue
        if dispatch_queue == "edf":
            from repro_torch.serving.admission import EDFDispatchQueue
            self._dispatch_queue_cls = EDFDispatchQueue
        else:
            self._dispatch_queue_cls = None      # worker default (FIFO)
        # retained for live instance spawn/drain (DESIGN.md §8)
        self._params_list = list(params_list)
        self._frontends = dict(frontends or {})
        self._fake = fake
        self._fake_delay_us = fake_delay_us
        self._use_kernel = use_kernel
        self.generation = 0              # bumped by each applied reconfig
        self.controller = None           # attached ReconfigController, if any
        self._profiler = None            # attached LiveBench sink, if any
        self.brownout = None             # attached BrownoutController (§11)
        self.trace_recorder = None       # attached TraceRecorder (§12)
        # global admitted-work budget (DESIGN.md §11 backpressure): an int
        # is a byte cap, an AdmissionBudget carries byte and/or row caps
        if admission_budget is None or \
                isinstance(admission_budget, AdmissionBudget):
            self.admission_budget = admission_budget
        else:
            self.admission_budget = AdmissionBudget(
                max_bytes=int(admission_budget))
        # fault tolerance (DESIGN.md §10): opt-in — unsupervised systems
        # keep the paper's §II.C.2 all-or-nothing sentinel semantics
        self._fault_plan = fault_plan
        self._nan_guard = nan_guard
        self.watchdog_s = watchdog_s
        self.retry_budget = retry_budget
        self.supervisor = None
        classes = {c.vocab_size for c in self.cfgs}
        if len(classes) != 1:
            raise ValueError(f"ensemble members disagree on class count: {classes}")
        self.num_classes = classes.pop()

        self.timers = StageTimers()
        # span tracing (DESIGN.md §13): the Tracer always exists so tracing
        # can be toggled at runtime; when disabled every emitter pays one
        # attribute check and no ring ever allocates
        from repro_torch.serving.tracing import Tracer
        self.tracer = Tracer(enabled=tracing, capacity=trace_capacity)
        self.prediction_queue: "queue.Queue[Message]" = queue.Queue()
        self.accumulator = PredictionAccumulator(
            self.prediction_queue, self.M, combine=combine, weights=weights,
            timers=self.timers, on_complete=self._on_request_complete,
            tracer=self.tracer, device=alloc.devices[0].torch_device)

        # request submission / in-flight window / buffer pool
        self._submit_lock = threading.Lock()
        self._pool_lock = threading.Lock()
        self._buffer_pool: List[np.ndarray] = []
        self._inflight = threading.BoundedSemaphore(self.max_in_flight)
        self._next_rid = 0

        self.combiners: Dict[int, DeviceCombiner] = {}
        self.workers: List[Worker] = []
        self._instances: Dict[int, List[Worker]] = {m: [] for m in range(self.M)}
        for d, m, batch in alloc.workers():
            if device_combine and d not in self.combiners:
                self.combiners[d] = DeviceCombiner(
                    f"d{d}", self.prediction_queue, timers=self.timers,
                    tracer=self.tracer)
            w = self._make_worker(d, m, batch, generation=0)
            self.workers.append(w)
            self._instances[m].append(w)

        self.accumulator.expect_ready(len(self.workers))
        self.accumulator.start()
        for w in self.workers:
            w.start()
        if not self.accumulator.all_ready.wait(ready_timeout):
            raise TimeoutError("workers failed to initialize")
        self._shutdown = False
        if supervise:
            # lazy import: control.supervisor imports worker health codes
            from repro_torch.serving.control.supervisor import Supervisor
            self.supervisor = Supervisor(
                self, watchdog_s=watchdog_s,
                interval_s=supervise_interval_s, retry_budget=retry_budget)
            for w in self.workers:       # contain crashes from the start
                w.on_crash = self.supervisor.on_worker_crash
            self.supervisor.start()

    # ---- live topology (online reconfiguration, DESIGN.md §8) ----------------
    def _make_worker(self, d: int, m: int, batch: int, *,
                     generation: int, oom_sentinel: bool = True) -> Worker:
        """Construct (and warm up) one worker; does NOT register it for
        routing.  The warm-up forward runs in the constructor, so a returned
        worker is immediately servable."""
        w = Worker(f"w{d}.{m}.g{generation}" if generation else f"w{d}.{m}",
                   self.cfgs[m], self._params_list[m],
                   self.alloc.devices[d], batch,
                   AdmissionQueue(), self.prediction_queue, m,
                   self.max_seq, self.segment_size, fake=self._fake,
                   frontend=self._frontends.get(m),
                   use_kernel=self._use_kernel,
                   combiner=self.combiners.get(d), timers=self.timers,
                   coalesce=self.coalesce, max_wait_us=self.max_wait_us,
                   linger=self.linger, generation=generation,
                   profiler=self._profiler, oom_sentinel=oom_sentinel,
                   fake_delay_us=self._fake_delay_us,
                   dispatch_ahead=self.dispatch_ahead,
                   fault_plan=self._fault_plan, nan_guard=self._nan_guard,
                   tracer=self.tracer,
                   member_dtype=self.member_dtypes[m],
                   dispatch_queue=self._dispatch_queue_cls)
        w.device_idx = d
        w.input_queue.trace_hook = self._trace_queue_event(w.worker_id)
        if self.supervisor is not None:   # supervised containment for live
            w.on_crash = self.supervisor.on_worker_crash   # spawns/respawns
        return w

    def _trace_queue_event(self, worker_id: str):
        """AdmissionQueue ``trace_hook`` for one worker: annotates the
        admission track with steal/drain migrations.  Plain enqueues are
        already covered by the submit span, so they return on one string
        compare."""
        tracer = self.tracer
        def hook(kind, items, level, _tr=tracer, _wid=worker_id):
            if kind == "enqueue" or not _tr.enabled or not items:
                return
            _tr.instant("admission", f"queue_{kind}",
                        rid=tuple(sorted({req.rid for req, _s in items})),
                        args={"worker": _wid, "units": len(items)})
        return hook

    def spawn_instance(self, d: int, m: int, batch_size: int, *,
                       generation: Optional[int] = None) -> Worker:
        """Live-add a data-parallel instance of member ``m`` on device ``d``
        at ``batch_size`` without touching in-flight requests.  The worker
        warms up (one forward, kernels built) *before* it is atomically
        spliced into the routing tables, so the first request striped to it
        never waits on a build.  Raises (without failing in-flight requests)
        when the device cannot host it; the worker frees what it had moved
        onto the card before it raises."""
        if self._shutdown:
            raise RuntimeError("system is shut down")
        gen = self.generation if generation is None else generation
        if self.device_combine:
            # registered before any descriptor can route to the new worker
            # (_make_worker and _on_request_complete read self.combiners)
            with self._submit_lock:
                if d not in self.combiners:
                    self.combiners[d] = DeviceCombiner(
                        f"d{d}", self.prediction_queue, timers=self.timers,
                        tracer=self.tracer)
        # warm-up forward outside the routing lock: submission stays live
        w = self._make_worker(d, m, batch_size, generation=gen,
                              oom_sentinel=False)
        w.start()
        with self._submit_lock:
            if self._shutdown:
                registered = False        # shut down during our warm-up:
            else:                         # never splice into a dead system
                self.workers.append(w)
                self._instances[m].append(w)
                self.alloc.A[d, m] = batch_size
                registered = True
        if not registered:
            w.input_queue.put(SHUTDOWN)   # tear the probe worker down
            raise RuntimeError("system shut down during spawn_instance")
        return w

    def drain_instance(self, w: Worker, *, migrate: bool = True,
                       wait: bool = True, timeout: float = 60.0) -> None:
        """Retire a live worker without dropping in-flight work: the worker
        is removed from the routing tables (no new descriptors), its queued
        descriptors are migrated to data-parallel siblings (combiner
        expected-row maps move with them) or, with ``migrate=False``, drained
        in place, and a ``SHUTDOWN`` sentinel lets the pipeline finish
        everything already accepted before the threads exit."""
        from repro_torch.serving.control.stealing import migrate_descriptors
        with self._submit_lock:
            if self._shutdown:
                # shutdown owns teardown: every worker drains its own queue
                # before exiting — migrating now would re-put descriptors
                # behind a sibling's SHUTDOWN, where they are discarded
                return
            inst = self._instances.get(w.model_idx, [])
            if w not in inst:
                return                    # already drained (idempotent)
            if len(inst) == 1:
                raise ValueError(
                    f"cannot drain {w.worker_id}: sole instance of member "
                    f"{w.model_idx} (every member must stay served)")
            inst.remove(w)
            self.workers.remove(w)
            if not any(x.device_idx == w.device_idx for x in inst):
                self.alloc.A[w.device_idx, w.model_idx] = 0
            if migrate:
                migrate_descriptors(self, w, inst)
        w.input_queue.put(SHUTDOWN)       # queued work (if any) drains first
        if wait and not w.join(timeout):
            w.release_device()            # threads gone: nothing reads them

    def quarantine_instance(self, w: Worker,
                            retry_budget: Optional[int] = None) -> None:
        """Contain a dead/stalled worker (DESIGN.md §10): remove it from
        routing atomically, then recover every outstanding unit it owned —
        its still-queued descriptors plus its in-flight ledger entries, a
        unit being exactly one or the other.

        With surviving data-parallel siblings the units are *resubmitted*
        (combiner expectations move with them, same as a drain migration);
        each affected request is charged one retry, and a request over its
        ``retry_budget`` fails with :class:`RetriesExhausted` instead.

        With no sibling (sole instance of the member) the units are
        *forgiven*: a per-unit forgiveness message lets the accumulator
        complete open requests with a degraded partial-ensemble combine,
        and the controller (if any) is asked to respawn the member.  Only
        when EVERY member has lost its last instance does the paper's
        global {-1, None, None} sentinel fire — nothing is left to degrade
        onto.

        Unlike :meth:`drain_instance` the pipeline is presumed dead: no
        SHUTDOWN is sent and no join is attempted — a stalled stage thread
        is leaked as a daemon, and the in-flight ledger pop-gate makes any
        late wakeup of it harmless (its completed contributions are
        skipped, never double-posted).  On the card a leaked thread keeps
        the worker's device tensors, and through its ``on_crash`` hook the
        system's, until it wakes, as the JAX package keeps its device
        buffers.  Idempotent; safe from the supervisor thread."""
        from repro_torch.serving.control.stealing import _transfer
        budget = self.retry_budget if retry_budget is None else retry_budget
        exhausted: List[int] = []
        member_down = None
        with self._submit_lock:
            if self._shutdown:
                return                    # shutdown owns teardown
            inst = self._instances.get(w.model_idx, [])
            if w not in inst:
                return                    # already quarantined/drained
            inst.remove(w)
            self.workers.remove(w)
            if not any(x.device_idx == w.device_idx for x in inst):
                self.alloc.A[w.device_idx, w.model_idx] = 0
            self.timers.inc("quarantines")
            if self.tracer.enabled:
                self.tracer.instant("admission", "quarantine",
                                    args={"worker": w.worker_id})
            # the final health verdict persists in the gauge snapshot after
            # the worker leaves the routing tables (serving_gauges only
            # refreshes live workers)
            self.timers.gauge(f"health.{w.worker_id}", HEALTH_DEAD)
            # outstanding units: queued descriptors (never entered the
            # pipeline) + in-flight ledger entries (admitted, not yet
            # forwarded).  Popping a ledger key here CLAIMS the unit
            # against the worker's own sender — dict.pop is GIL-atomic,
            # so exactly one side wins (replay idempotency).
            units = list(w.input_queue.drain_descriptors())
            for key in list(w._ledger.keys()):
                req = w._ledger.pop(key, None)
                if req is not None:
                    units.append((req, key[1]))
            units = [(req, s) for req, s in units if not req.dropped()]
            if inst:
                # one retry charged per request per quarantine event (not
                # per unit — losing a worker is one failure)
                charged: Dict[int, Request] = {}
                for req, _ in units:
                    if req.rid not in charged:
                        req.retries += 1
                        charged[req.rid] = req
                exhausted = [rid for rid, req in charged.items()
                             if req.retries > budget]
                dead_rids = set(exhausted)
                replayed = 0
                for req, s in units:
                    if req.rid in dead_rids:
                        continue          # fail() below tears down maps
                    dst = inst[(s + req.rid) % len(inst)]
                    _transfer(req, s, w, dst)
                    dst.input_queue.put((req, s), req.priority)
                    replayed += 1
                if replayed:
                    self.timers.inc("segments_replayed", replayed)
                if self.tracer.enabled:
                    # chunk-replay provenance: which requests were re-striped
                    # off the quarantined worker, and how many units moved
                    self.tracer.instant(
                        "admission", "quarantine_replay",
                        rid=tuple(sorted({req.rid for req, _ in units})),
                        args={"worker": w.worker_id, "replayed": replayed,
                              "exhausted": len(exhausted)})
            elif all(len(v) == 0 for v in self._instances.values()):
                # last instance of the last member: nothing left to degrade
                # onto — the paper's global sentinel applies (and it must be
                # the ONLY message, or forgiveness would complete requests
                # at quality 0 before the sentinel fails them)
                self.prediction_queue.put(Message(OOM, None, None))
            else:
                member_down = (w.model_idx, w.device_idx, w.batch_size)
                for req, s in units:
                    if w.combiner is not None and \
                            not w.combiner.unexpect(req, s):
                        continue          # request already torn down
                    # forgiveness message: P=None with s >= 0 — the
                    # accumulator debits the member's rows for this
                    # segment and tracks the missing weight for the
                    # completion-time renormalization
                    self.prediction_queue.put(Message(
                        s, w.model_idx, None, rid=req.rid))
        # outside the lock: fail() -> on_complete re-acquires _submit_lock
        for rid in exhausted:
            self.accumulator.fail(rid, RetriesExhausted(
                f"request {rid} lost workers more than retry_budget="
                f"{budget} times"))
        if member_down is not None and self.controller is not None:
            self.controller.note_member_down(*member_down)

    def demote_request(self, rid: int, keep_members) -> bool:
        """Demote in-flight request ``rid`` to the members in
        ``keep_members`` (brownout, DESIGN.md §11): members outside the set
        are added to ``Request.demoted`` and every stage *forgives* their
        remaining units — the batcher never packs them, the predictor never
        dispatches fully-demoted chunks, and the sender discards staged
        rows behind the in-flight-ledger pop-gate — so the request
        completes with a renormalized partial-ensemble answer instead of
        waiting out the heavy backlog.  Marking is GIL-atomic ``set.add``
        (advisory: a unit that raced past a stage's check is simply served;
        accounting closes either way).  Refuses 'pallas' requests (the
        fused combine needs every member) and never demotes a request's
        last remaining member.  Returns True when at least one member was
        demoted."""
        with self.accumulator._lock:
            handle = self.accumulator._requests.get(rid)
        if handle is None:
            return False                  # already completed/failed
        req = handle.req
        if req.combine == "pallas":
            return False
        keep = set(keep_members)
        kept = [m for m in req.members
                if m in keep and m not in req.demoted]
        drop = [m for m in req.members
                if m not in keep and m not in req.demoted]
        if not kept or not drop:
            return False
        for m in drop:
            req.demoted.add(m)
        self.timers.inc("requests_demoted")
        self.timers.inc("members_demoted", len(drop))
        if self.tracer.enabled:
            self.tracer.instant("admission", "demote", rid=rid,
                                args={"drop": sorted(drop),
                                      "kept": sorted(kept)})
        return True

    def retry_after_s(self) -> float:
        """Drain-estimate-derived retry hint shared by the 429 and 503
        responses (DESIGN.md §11): roughly how long until the deepest
        worker backlog clears, never a hardcoded constant."""
        if self.brownout is not None:
            return self.brownout.drain_estimate_s()
        from repro_torch.serving.control.overload import estimate_drain_s
        return estimate_drain_s(self, self._profiler)

    def set_profiler(self, profiler) -> None:
        """Attach a live-bench sink (``observe``/``note_request``); workers
        report per-batch latency and the broadcaster reports per-member
        demand to it (DESIGN.md §8)."""
        with self._submit_lock:
            self._profiler = profiler
            for w in self.workers:
                w.profiler = profiler

    def instances(self, m: int) -> List[Worker]:
        """Snapshot of member ``m``'s live data-parallel instances."""
        with self._submit_lock:
            return list(self._instances[m])

    # ---- per-request input buffers (versioned swap) --------------------------
    def _take_buffer(self, n: int, width: int) -> np.ndarray:
        """Best-fit reuse: the smallest pooled buffer that holds ``n`` rows.
        First-fit would let one huge early request pin oversized buffers on
        every later small request for the rest of the session."""
        with self._pool_lock:
            best = -1
            for i, b in enumerate(self._buffer_pool):
                if b.shape[0] >= n and b.shape[1] == width and (
                        best < 0 or
                        b.shape[0] < self._buffer_pool[best].shape[0]):
                    best = i
            if best >= 0:
                return self._buffer_pool.pop(best)
        return np.zeros((max(n, self.segment_size), width), np.int32)

    def _on_request_complete(self, handle: RequestHandle) -> None:
        # under the topology lock: spawn_instance may add combiners
        # concurrently, and a steal's unexpect/expect_one pair (which holds
        # this lock) must not interleave with the teardown — finish() racing
        # between the two would let expect_one resurrect state for a dead
        # request that nothing ever cleans up again
        with self._submit_lock:
            for c in self.combiners.values():
                c.finish(handle.req.rid)
        with self._pool_lock:
            # a cancelled/expired request's buffer may still be read by a
            # batcher that hasn't popped its descriptors yet — never hand it
            # to a later request (the versioned-buffer guarantee, §3).  The
            # same holds after a quarantine (retries > 0 / degraded rows): a
            # stalled-but-alive quarantined worker may still read the buffer
            # whenever its threads wake up
            if handle.error is None and handle.req.retries == 0 and \
                    handle.degraded_rows == 0 and \
                    not handle.keep_buffer and \
                    len(self._buffer_pool) <= self.max_in_flight:
                self._buffer_pool.append(handle.req.x)
        charge = handle.req.budget_charge
        if charge is not None:
            handle.req.budget_charge = None
            self._credit_admission(charge)
        self._inflight.release()

    def _request_weights(self, members: List[int],
                         combine: str) -> Dict[int, float]:
        """Per-member combine weights, normalized over the active subset
        (paper §I.B "ensemble selection")."""
        if combine == "vote":
            return {m: 1.0 / len(members) for m in members}
        base = self.accumulator.weights
        wsum = float(base[members].sum())
        return {m: float(base[m]) / max(wsum, 1e-12) for m in members}

    # ---- the segment ids broadcaster -----------------------------------------
    def _broadcast(self, X: np.ndarray, members=None,
                   options: Optional[PredictOptions] = None, *,
                   plan: bool = True,
                   t_entry: Optional[float] = None) -> RequestHandle:
        """Admit one request; ``t_entry`` is when its caller asked
        (``predict_async``'s entry), where its ``admission_wait`` and its
        ``submit`` span start."""
        if t_entry is None:
            t_entry = time.perf_counter()
        opts = options or PredictOptions()
        n, width = X.shape
        if members is None:
            members = opts.members
        members = list(range(self.M)) if members is None else list(members)
        if any(m < 0 or m >= self.M for m in members):
            raise ValueError(f"member ids out of range: {members}")
        if opts.member_dtype is not None:
            # precision floor (DESIGN.md §14): keep members executing at the
            # requested precision or better (fp32 > bf16 > int8/fp8)
            from repro_torch.kernels.quant import meets_precision
            eligible = [m for m in members
                        if meets_precision(self.member_dtypes[m],
                                           opts.member_dtype)]
            if not eligible:
                raise MemberUnavailable(
                    f"no requested member executes at precision "
                    f">= {opts.member_dtype!r} "
                    f"(dtypes: {[self.member_dtypes[m] for m in members]})")
            members = eligible
        combine = opts.combine or self.combine
        if combine not in _COMBINE_RULES:
            raise ValueError(f"unknown combine rule {combine!r}")
        rec = self.trace_recorder
        if rec is not None and plan and n > 0 and members:
            # record the *offered* request — before brownout tier planning
            # or admission control can trim it — so a replayed trace
            # regenerates the original demand (DESIGN.md §12)
            rec.record(n, priority=opts.priority,
                       deadline_ms=opts.deadline_ms, members=members)
        if n == 0 or not members:
            # zero-work request: resolve immediately instead of taking an
            # in-flight slot and completing synchronously inside _submit —
            # begin()'s remaining==0 fast path would fire on_complete while
            # the submit lock is held (self-deadlock on the topology lock)
            return self._resolved_handle(X, n, members, combine)
        # overload layer (DESIGN.md §11): tier planning + cost-aware
        # admission.  At brownout level 0 (and with no controller/budget
        # attached) every branch below is a no-op, so zero-pressure results
        # stay bit-identical to the pre-brownout engine.  ``plan=False`` is
        # the cascade-escalation path: it must reach the heavy members the
        # tier just dropped.
        tier_quality = 1.0
        escalate: List[int] = []
        ctl = self.brownout
        if ctl is not None and plan:
            requested = members
            members, tier_quality = ctl.plan_members(members, opts)
            if tier_quality < 1.0 and ctl.cascade_margin is not None:
                escalate = [m for m in requested if m not in members]
            ctl.check_admission(n, members, opts)  # may raise Overloaded
        charge = None
        if self.admission_budget is not None:
            nbytes, rows = n * width * 4, n * len(members)
            if not self.admission_budget.try_charge(nbytes, rows):
                self.timers.inc("admission_rejections")
                raise Overloaded(
                    "admission byte/row budget exhausted",
                    retry_after_s=round(self.retry_after_s(), 3))
            charge = (nbytes, rows)
        deadline = opts.deadline_at()     # fixed at admission
        remaining = None if deadline is None \
            else deadline - time.perf_counter()
        # bounded in-flight window; a deadline bounds the wait for a slot,
        # and an already-expired request fails fast without enqueuing work
        if remaining is not None and (
                remaining <= 0 or
                not self._inflight.acquire(timeout=remaining)):
            self._credit_admission(charge)
            return self._resolved_handle(X, 0, members, combine,
                                         DeadlineExceeded(
                                             "deadline expired at admission"))
        if remaining is None:
            self._inflight.acquire()
        try:
            handle = self._submit(X, n, width, members, combine, opts,
                                  deadline, tier_quality=tier_quality,
                                  charge=charge,
                                  keep_buffer=bool(escalate),
                                  t_entry=t_entry)
        except BaseException:
            self._inflight.release()      # a failed submit must not leak a slot
            self._credit_admission(charge)   # the request never went live
            raise
        if escalate:
            from repro_torch.serving.control.overload import CascadeHandle
            return CascadeHandle(self, handle, escalate,
                                 ctl.cascade_margin, opts)
        return handle

    def _credit_admission(self, charge) -> None:
        if charge is not None and self.admission_budget is not None:
            self.admission_budget.credit(*charge)

    def _resolved_handle(self, X, n: int, members, combine,
                         error: Optional[BaseException] = None
                         ) -> RequestHandle:
        """A pre-resolved handle that never entered the pipeline: the
        fail-fast path (``error`` set, built with n=0 so no result matrix
        is allocated just to raise) and the zero-work path (no rows or no
        members — ``Y`` stays the (n, classes) zero matrix)."""
        req = Request(-1, X, n, self.num_classes, self.segment_size,
                      list(members), {}, combine)
        handle = RequestHandle(req)
        handle.error = error
        handle._finished = True
        handle.done.set()
        return handle

    def _submit(self, X: np.ndarray, n: int, width: int,
                members: List[int], combine: str, opts: PredictOptions,
                deadline: Optional[float], *, tier_quality: float = 1.0,
                charge=None, keep_buffer: bool = False,
                t_entry: float) -> RequestHandle:
        with self._submit_lock:
            if self._shutdown:
                # the unsynchronized predict_async check can race shutdown()
                # while we block on the in-flight window; descriptors
                # enqueued now would land behind SHUTDOWN and be discarded
                # (the handle would hang until the client timeout)
                raise RuntimeError("system is shut down")
            dead = [m for m in members if not self._instances[m]]
            if dead:
                # a quarantined member with no respawn yet: fail fast with
                # the retryable taxonomy (HTTP 503 + Retry-After) instead
                # of dividing by zero in the striping below.  Checked
                # before begin() so nothing registers in the accumulator.
                raise MemberUnavailable(
                    f"members {dead} have no live instance "
                    f"(quarantined; respawn pending)")
            if self._profiler is not None:    # live per-member demand (§8)
                self._profiler.note_request(members, n)
            rid = self._next_rid
            self._next_rid += 1
            buf = self._take_buffer(n, width)
            buf[:n] = X
            req = Request(rid, buf, n, self.num_classes, self.segment_size,
                          members, self._request_weights(members, combine),
                          combine, priority=opts.level(), deadline=deadline,
                          t_submit=time.perf_counter())
            handle = self.accumulator.begin(req, on_segment=opts.on_segment)
            if tier_quality < 1.0:
                # brownout tier (DESIGN.md §11): the request was planned
                # against a member subset — stamp the served weight
                # fraction; mid-flight degradation multiplies onto it
                handle.quality = tier_quality
            handle.keep_buffer = keep_buffer
            # static striping: (s, m) -> one instance; makes per-device
            # contribution counts deterministic for the partial combine.
            # Rotating by rid spreads single-segment (small) requests across
            # data-parallel instances instead of pinning them all to s=0's
            # instance; the combiner's expected map derives from this same
            # plan, so flush accounting still closes.
            plan = []
            for s in range(req.num_segments()):
                for m in members:
                    inst = self._instances[m]
                    plan.append((inst[(s + rid) % len(inst)], s))
            if self.combiners:
                expected: Dict[int, list] = {}
                for w, s in plan:
                    comb, exp = expected.setdefault(id(w.combiner),
                                                    [w.combiner, {}])
                    exp[s] = exp.get(s, 0) + 1
                for comb, exp in expected.values():
                    comb.begin(req, exp)
            for w, s in plan:
                w.input_queue.put((req, s), req.priority)
            # from the caller's entry to the last descriptor queued: tier
            # planning, the budget, the in-flight window, this lock and the
            # striping
            t_queued = time.perf_counter()
            self.timers.add("admission_wait", t_queued - t_entry)
            # budget ownership transfers to the live request LAST (nothing
            # below here raises): from now on _on_request_complete credits
            # it back exactly once; any earlier exception leaves it unset
            # and _broadcast's except path credits instead
            req.budget_charge = charge
            if self.tracer.enabled:
                # the admission span, from the caller's entry: the root of
                # the request's timeline (DESIGN.md §13)
                self.tracer.ring("admission").append(
                    ("X", "submit", t_entry, t_queued - t_entry, rid,
                     {"priority": req.priority, "members": list(members),
                      "rows": n, "quality": tier_quality,
                      "deadline_ms": None if deadline is None else round(
                          1e3 * (deadline - req.t_submit), 1)},
                     None, None))
        return handle

    # ---- modes -----------------------------------------------------------------
    def predict_async(self, X: np.ndarray, members=None,
                      options: Optional[PredictOptions] = None) -> RequestHandle:
        """Submit a request without waiting; overlaps with other in-flight
        requests up to ``max_in_flight``.  Returns a handle with
        ``result(timeout)`` and ``cancel()``.  ``options`` carries the
        per-request intent (priority / deadline / members / combine /
        streaming — DESIGN.md §7); the ``members`` argument wins over
        ``options.members`` when both are given."""
        t_entry = time.perf_counter()
        if self._shutdown:
            raise RuntimeError("system is shut down")
        return self._broadcast(np.asarray(X, np.int32), members, options,
                               t_entry=t_entry)

    def predict(self, X: np.ndarray, timeout: float = 600.0,
                members=None,
                options: Optional[PredictOptions] = None) -> np.ndarray:
        """Deploy Mode.  ``members``: optional model-id subset (paper §I.B
        "ensemble selection" — e.g. a faster accuracy/speed trade-off)."""
        handle = self.predict_async(X, members, options)
        try:
            return handle.result(timeout)
        except MemoryError:
            self.shutdown()
            raise

    def benchmark(self, X: np.ndarray, repeats: int = 1,
                  timeout: float = 600.0):
        """Benchmark Mode: returns (Y, throughput samples/sec).  Repeats are
        issued through the in-flight window, so the pipeline stays full."""
        X = np.asarray(X, np.int32)
        Y = self.predict(X, timeout)          # warm the path once
        t0 = time.perf_counter()
        handles = [self.predict_async(X) for _ in range(repeats)]
        for h in handles:
            Y = h.result(timeout)
        dt = time.perf_counter() - t0
        return Y, repeats * X.shape[0] / dt

    def quiesce(self, wait: bool = False, timeout: float = 30.0) -> bool:
        """Force every worker's batcher to flush its partially-filled
        coalesced batch immediately instead of lingering ``max_wait_us`` —
        useful before latency-sensitive waits or a drain.

        Re-entrant: quiesce is a *flush*, not a teardown — ``predict_async``
        stays legal afterwards and further quiesce/submit cycles may repeat
        (the drain/restart loop the reconfiguration controller relies on,
        DESIGN.md §8).  With ``wait=True`` the call blocks until every live
        batcher has processed its flush AND every chunk flushed before the
        barrier has been dispatched (the :class:`FlushBarrier` rides the
        chunk dispatch queue and is acknowledged by the predictor), and
        returns whether all barriers were reached within ``timeout``.
        Sentinels are enqueued under the topology lock: a concurrent
        ``drain_instance`` removes its worker under the same lock *before*
        sending ``SHUTDOWN``, so a barrier is only ever queued ahead of a
        worker's SHUTDOWN (and the batcher's shutdown path releases any
        barrier that still slipped behind it) — quiesce cannot stall on a
        retiring worker."""
        with self._submit_lock:
            if self._shutdown:            # nothing left to flush; a barrier
                return True               # would stall on dead batchers
            workers = list(self.workers)
            if not wait:
                for w in workers:
                    w.input_queue.put(FLUSH)
                return True
            barriers = []
            for w in workers:
                b = FlushBarrier()
                w.input_queue.put(b)
                barriers.append(b)
        deadline = time.perf_counter() + timeout
        return all(b.done.wait(max(0.0, deadline - time.perf_counter()))
                   for b in barriers)

    def stage_timings(self) -> Dict[str, Dict[str, float]]:
        """Per-stage wall-clock counters (batcher wait / fill / predict /
        transfer / combine / accumulate) since construction or reset."""
        return self.timers.snapshot()

    def serving_counters(self) -> Dict[str, float]:
        """Coalescing counters (rows_valid / rows_dispatched / batches /
        spans) plus derived padding efficiency."""
        c = self.timers.counter_snapshot()
        c["padding_efficiency"] = self.timers.padding_efficiency()
        return c

    def serving_gauges(self) -> Dict[str, Dict[str, float]]:
        """Sampled gauges, keyed per worker (``queue_depth.<worker_id>``:
        that batcher's input-queue backlog at each drain) plus the rolling
        ``hp_p50_ms`` high-priority median latency and each worker's
        ``health.<worker_id>`` verdict (0=READY / 1=DEGRADED / 2=DEAD —
        quarantined workers keep their final DEAD reading)."""
        with self._submit_lock:
            workers = list(self.workers)
        for w in workers:                 # fresh verdicts for live workers
            self.timers.gauge(f"health.{w.worker_id}",
                              w.health(self.watchdog_s))
        return self.timers.gauge_snapshot()

    def latency_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-priority-class end-to-end request latency percentiles
        ({"high"/"normal": {p50_ms, p99_ms, n}}) over a rolling window —
        the SLO view the chunk-granular preemption targets (DESIGN.md §3)."""
        return self.timers.latency_snapshot()

    def shutdown(self):
        with self._submit_lock:
            # flag + snapshot under the topology lock: a concurrent
            # quiesce(wait=True) either sees _shutdown (and skips) or its
            # barriers land ahead of our SHUTDOWNs and get acknowledged
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self.workers)
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.controller is not None:
            self.controller.stop()
        if self.brownout is not None:
            self.brownout.stop()
        for w in workers:
            w.input_queue.put(SHUTDOWN)
        for w in workers:
            w.join()
        self.accumulator.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
