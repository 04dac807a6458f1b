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
    segment instead of one per member per segment;
  * requests are tagged with ids and pipelined — up to ``max_in_flight``
    ``predict_async()`` calls overlap, so the coalescing batchers see rows
    from many small concurrent requests; ``quiesce()`` force-flushes any
    lingering partial batches.

The port serves the main path, cross-attention members included
(``frontends``: member index -> (batch, F, fdim) embeddings, held on the
member's device; zeros where a member has none).  The options whose modules
are not ported yet raise ``NotImplementedError`` naming the ROADMAP item:
supervision and fault plans, live spawn/drain/steal, brownout and the
admission budget (Queue 1 item 8).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocation import AllocationMatrix
from repro_torch.kernels.quant import meets_precision, validate_member_dtype
from repro_torch.serving.accumulator import PredictionAccumulator, RequestHandle
from repro_torch.serving.admission import AdmissionQueue
from repro_torch.serving.combiner import DeviceCombiner
from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.segments import (DEFAULT_SEGMENT_SIZE, FLUSH,
                                          FlushBarrier, SHUTDOWN,
                                          DeadlineExceeded, MemberUnavailable,
                                          Message, PredictOptions, Request)
from repro_torch.serving.tracing import Tracer
from repro_torch.serving.worker import DISPATCH_AHEAD, Worker

_COMBINE_RULES = ("mean", "weighted", "vote", "pallas")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} needs the control plane (ROADMAP "
                               f"Queue 1 item 8), which is not ported yet")


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
                 nan_guard: bool = False,
                 admission_budget=None,
                 tracing: bool = False,
                 trace_capacity: int = 4096,
                 member_dtypes: Optional[Sequence[Optional[str]]] = None,
                 dispatch_queue: str = "fifo"):
        if supervise or fault_plan is not None:
            raise _not_ported("supervise=True / fault_plan")
        if admission_budget is not None:
            raise _not_ported("admission_budget")
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
        # (non-preemptible) window (DESIGN.md §3)
        self.dispatch_ahead = DISPATCH_AHEAD if dispatch_ahead is None \
            else dispatch_ahead
        self.M = len(self.cfgs)
        # per-member execution precision (DESIGN.md §14)
        if member_dtypes is None:
            self.member_dtypes: List[str] = ["fp32"] * self.M
        else:
            if len(member_dtypes) != self.M:
                raise ValueError(
                    f"member_dtypes needs {self.M} entries, "
                    f"got {len(member_dtypes)}")
            self.member_dtypes = [validate_member_dtype(dt or "fp32")
                                  for dt in member_dtypes]
        if dispatch_queue not in ("fifo", "edf"):
            raise ValueError(f"dispatch_queue must be 'fifo' or 'edf', "
                             f"got {dispatch_queue!r}")
        self.dispatch_queue = dispatch_queue
        if dispatch_queue == "edf":
            from repro_torch.serving.admission import EDFDispatchQueue
            self._dispatch_queue_cls = EDFDispatchQueue
        else:
            self._dispatch_queue_cls = None      # worker default (FIFO)
        self._frontends = dict(frontends or {})
        self._fake = fake
        self._fake_delay_us = fake_delay_us
        self._use_kernel = use_kernel
        self._nan_guard = nan_guard
        self.watchdog_s = watchdog_s
        classes = {c.vocab_size for c in self.cfgs}
        if len(classes) != 1:
            raise ValueError(f"ensemble members disagree on class count: {classes}")
        self.num_classes = classes.pop()

        self.timers = StageTimers()
        # span tracing (DESIGN.md §13): the Tracer always exists so tracing
        # can be toggled at runtime
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
        # the parameter trees are not retained: each worker moves (and, for
        # a quantized member, narrows) its own copy onto its device
        params_list = list(params_list)
        for d, m, batch in alloc.workers():
            if device_combine and d not in self.combiners:
                self.combiners[d] = DeviceCombiner(
                    f"d{d}", self.prediction_queue, timers=self.timers,
                    tracer=self.tracer)
            w = self._make_worker(d, m, batch, params_list[m])
            self.workers.append(w)
            self._instances[m].append(w)
        del params_list

        self.accumulator.expect_ready(len(self.workers))
        self.accumulator.start()
        for w in self.workers:
            w.start()
        if not self.accumulator.all_ready.wait(ready_timeout):
            raise TimeoutError("workers failed to initialize")
        self._shutdown = False

    def _make_worker(self, d: int, m: int, batch: int, params) -> Worker:
        """Construct (and warm up) one worker; the warm-up forward runs in
        the constructor, so a returned worker is immediately servable."""
        w = Worker(f"w{d}.{m}", self.cfgs[m], params,
                   self.alloc.devices[d], batch,
                   AdmissionQueue(), self.prediction_queue, m,
                   self.max_seq, self.segment_size, fake=self._fake,
                   frontend=self._frontends.get(m),
                   use_kernel=self._use_kernel,
                   combiner=self.combiners.get(d), timers=self.timers,
                   coalesce=self.coalesce, max_wait_us=self.max_wait_us,
                   linger=self.linger,
                   fake_delay_us=self._fake_delay_us,
                   dispatch_ahead=self.dispatch_ahead,
                   nan_guard=self._nan_guard, tracer=self.tracer,
                   member_dtype=self.member_dtypes[m],
                   dispatch_queue=self._dispatch_queue_cls)
        w.device_idx = d
        return w

    # ---- live topology: not ported in this slice ----------------------------
    def spawn_instance(self, d: int, m: int, batch_size: int, **kw) -> Worker:
        raise _not_ported("spawn_instance")

    def drain_instance(self, w: Worker, **kw) -> None:
        raise _not_ported("drain_instance")

    def quarantine_instance(self, w: Worker, **kw) -> None:
        raise _not_ported("quarantine_instance")

    def demote_request(self, rid: int, keep_members) -> bool:
        raise _not_ported("demote_request (brownout)")

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
        with self._submit_lock:
            for c in self.combiners.values():
                c.finish(handle.req.rid)
        with self._pool_lock:
            # a cancelled/expired request's buffer may still be read by a
            # batcher that hasn't popped its descriptors yet — never hand it
            # to a later request (the versioned-buffer guarantee, §3)
            if handle.error is None and \
                    len(self._buffer_pool) <= self.max_in_flight:
                self._buffer_pool.append(handle.req.x)
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
                   options: Optional[PredictOptions] = None) -> RequestHandle:
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
        if n == 0 or not members:
            # zero-work request: resolve immediately instead of taking an
            # in-flight slot (begin()'s remaining==0 fast path would fire
            # on_complete while the submit lock is held)
            return self._resolved_handle(X, n, members, combine)
        deadline = opts.deadline_at()     # fixed at admission
        remaining = None if deadline is None \
            else deadline - time.perf_counter()
        # bounded in-flight window; a deadline bounds the wait for a slot,
        # and an already-expired request fails fast without enqueuing work
        if remaining is not None and (
                remaining <= 0 or
                not self._inflight.acquire(timeout=remaining)):
            return self._resolved_handle(X, 0, members, combine,
                                         DeadlineExceeded(
                                             "deadline expired at admission"))
        if remaining is None:
            self._inflight.acquire()
        try:
            return self._submit(X, n, width, members, combine, opts, deadline)
        except BaseException:
            self._inflight.release()      # a failed submit must not leak a slot
            raise

    def _resolved_handle(self, X, n: int, members, combine,
                         error: Optional[BaseException] = None
                         ) -> RequestHandle:
        """A pre-resolved handle that never entered the pipeline: the
        fail-fast path (``error`` set) and the zero-work path."""
        req = Request(-1, X, n, self.num_classes, self.segment_size,
                      list(members), {}, combine)
        handle = RequestHandle(req)
        handle.error = error
        handle._finished = True
        handle.done.set()
        return handle

    def _submit(self, X: np.ndarray, n: int, width: int,
                members: List[int], combine: str, opts: PredictOptions,
                deadline: Optional[float]) -> RequestHandle:
        with self._submit_lock:
            if self._shutdown:
                # descriptors enqueued now would land behind SHUTDOWN
                raise RuntimeError("system is shut down")
            rid = self._next_rid
            self._next_rid += 1
            buf = self._take_buffer(n, width)
            buf[:n] = X
            req = Request(rid, buf, n, self.num_classes, self.segment_size,
                          members, self._request_weights(members, combine),
                          combine, priority=opts.level(), deadline=deadline,
                          t_submit=time.perf_counter())
            handle = self.accumulator.begin(req, on_segment=opts.on_segment)
            # static striping: (s, m) -> one instance; makes per-device
            # contribution counts deterministic for the partial combine.
            # Rotating by rid spreads single-segment requests across
            # data-parallel instances.
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
            if self.tracer.enabled:
                # the admission span: the root of the request's timeline
                self.tracer.ring("admission").append(
                    ("X", "submit", req.t_submit,
                     time.perf_counter() - req.t_submit, rid,
                     {"priority": req.priority, "members": list(members),
                      "rows": n, "quality": 1.0,
                      "deadline_ms": None if deadline is None else round(
                          1e3 * (deadline - req.t_submit), 1)},
                     None, None))
        return handle

    # ---- modes -----------------------------------------------------------------
    def predict_async(self, X: np.ndarray, members=None,
                      options: Optional[PredictOptions] = None) -> RequestHandle:
        """Submit a request without waiting; overlaps with other in-flight
        requests up to ``max_in_flight``.  Returns a handle with
        ``result(timeout)`` and ``cancel()``."""
        if self._shutdown:
            raise RuntimeError("system is shut down")
        return self._broadcast(np.asarray(X, np.int32), members, options)

    def predict(self, X: np.ndarray, timeout: float = 600.0,
                members=None,
                options: Optional[PredictOptions] = None) -> np.ndarray:
        """Deploy Mode.  ``members``: optional model-id subset (paper §I.B
        "ensemble selection")."""
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
        coalesced batch immediately instead of lingering ``max_wait_us``.
        Re-entrant.  With ``wait=True`` the call blocks until every batcher
        has processed its flush AND every chunk flushed before the barrier
        has been dispatched, and returns whether all barriers were reached
        within ``timeout``."""
        with self._submit_lock:
            if self._shutdown:
                return True
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
        """Per-stage wall-clock counters since construction or reset."""
        return self.timers.snapshot()

    def serving_counters(self) -> Dict[str, float]:
        """Coalescing counters plus derived padding efficiency."""
        c = self.timers.counter_snapshot()
        c["padding_efficiency"] = self.timers.padding_efficiency()
        return c

    def serving_gauges(self) -> Dict[str, Dict[str, float]]:
        """Sampled gauges (queue depths, health verdicts)."""
        with self._submit_lock:
            workers = list(self.workers)
        for w in workers:
            self.timers.gauge(f"health.{w.worker_id}",
                              w.health(self.watchdog_s))
        return self.timers.gauge_snapshot()

    def latency_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-priority-class end-to-end request latency percentiles."""
        return self.timers.latency_snapshot()

    def shutdown(self):
        with self._submit_lock:
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self.workers)
        for w in workers:
            w.input_queue.put(SHUTDOWN)
        for w in workers:
            w.join()
        self.accumulator.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
