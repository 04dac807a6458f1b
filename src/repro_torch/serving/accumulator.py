"""The prediction accumulator (paper §II.C.2), multi-request edition.

Consumes messages from the single prediction queue and folds them into the
per-request ensemble prediction.  Two message kinds (DESIGN.md §§3-4):

  * **device partials** (``m is None``): already-weighted sums of ``count``
    member predictions, pre-combined on one device — the fold is just
    ``Y[start(s):end(s)] += P``;
  * **per-member messages** (legacy path, ``device_combine=False``): the
    paper's {s, m, P} triplet, folded under the request's combine rule —
    "mean"/"weighted" (``Y += w_m P``), "vote" (majority voting on argmax),
    or "pallas" (buffer the segment's M member predictions, then fuse the
    weighted combine in the ensemble_combine Pallas kernel, DESIGN.md §9.4).

Under the coalescing scheduler one member's segment may arrive split across
several messages (each tagged with ``row_lo``), so completion accounting
counts **rows, not messages**: a request owes ``n × len(members)``
member-rows, a per-member message debits ``len(P)`` rows, and a device
partial debits ``count × segment_rows``.  The total is invariant to how the
batcher packed the spans.  Early-forward audit (chunk-granular pipeline,
DESIGN.md §3): because nothing here assumes slot order — segments may
complete in any order, rows in any split — a sender forwarding a segment
the moment its last chunk returns (before its slot retires, possibly out
of segment order under priority reordering) needs no changes on this side;
the same row arithmetic closes.

Every message carries a request id, so any number of requests can be in
flight; each ``begin()`` returns a :class:`RequestHandle` the caller waits
on, and a completion callback lets the system recycle the request's input
buffer and open the in-flight window for the next request.

Request-API duties (DESIGN.md §7):
  * **deadlines** are enforced here as well as at admission — a message for
    an expired request fails the handle with :class:`DeadlineExceeded`
    instead of folding further rows, and a batcher that dropped a queued
    descriptor posts ``Message(DROPPED, ...)`` so the failure surfaces even
    when no rows ever arrive;
  * **cancellation**: ``RequestHandle.cancel()`` resolves the future with
    :class:`RequestCancelled` immediately and marks the request so batchers
    skip still-queued descriptors; completion is idempotent (a straggler
    message folding concurrently with ``cancel()`` cannot double-release
    the in-flight window);
  * **streaming partials**: with ``on_segment`` set, per-segment row
    accounting fires ``on_segment(s, lo, hi, Y[lo:hi])`` the moment a
    segment's ensemble rows close — however the spans were packed.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.serving import segments as seg
from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.segments import (DeadlineExceeded, MemberUnavailable,
                                    Message, Request, RequestCancelled,
                                    RetriesExhausted)


class RequestHandle:
    """Per-request accumulation state + the client-side future."""

    def __init__(self, req: Request,
                 on_segment: Optional[Callable] = None):
        self.req = req
        self.Y = np.zeros((req.n, req.num_classes), np.float32)
        # member-rows still owed: every member predicts every row exactly once
        self.remaining = req.n * len(req.members)
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        # submission-to-completion seconds, set before ``done`` on success
        self.latency_s: Optional[float] = None
        self.messages = 0                     # data messages folded
        # graceful degradation (DESIGN.md §10): member-rows forgiven because
        # their member lost its last instance mid-request.  quality is the
        # fraction of member-rows actually served (1.0 = full ensemble);
        # _missing_w tracks the per-row missing combine weight so completed
        # rows renormalize over the members that did report.
        self.quality = 1.0
        self.degraded_rows = 0
        # brownout cascade (DESIGN.md §11): the system must not recycle the
        # request's input buffer at completion — a low-margin result may
        # resubmit the same rows to the escalation members
        self.keep_buffer = False
        self._missing_w: Optional[np.ndarray] = None
        self.on_segment = on_segment          # streaming-partials callback
        self._seg_buffers: Dict[int, Dict[int, np.ndarray]] = {}
        self._seg_rows: Dict[int, int] = {}   # pallas path: rows buffered
        self._finished = False                # guarded by accumulator lock
        self._canceller: Optional["PredictionAccumulator"] = None
        if on_segment is not None:            # member-rows owed per segment
            self._seg_remaining = {
                s: (req.bounds(s)[1] - req.bounds(s)[0]) * len(req.members)
                for s in range(req.num_segments())}
        else:
            self._seg_remaining = None

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("prediction accumulator timed out")
        if self.error is not None:
            raise self.error
        return self.Y

    def cancel(self) -> bool:
        """Resolve the future with :class:`RequestCancelled` and mark the
        request so pipeline stages drop its remaining work.  Returns False
        when the request already completed (or was never registered).  Rows
        already packed into ring slots still flow through the pipeline —
        their messages are dropped as stale — but the in-flight window slot
        and combiner state are released immediately."""
        self.req.cancel_event.set()
        if self._canceller is None:
            return False
        return self._canceller.fail(
            self.req.rid, RequestCancelled(f"request {self.req.rid} cancelled"))


class PredictionAccumulator:
    def __init__(self, prediction_queue: "queue.Queue[Message]",
                 num_models: int, *, combine: str = "mean",
                 weights: Optional[np.ndarray] = None,
                 timers: Optional[StageTimers] = None,
                 on_complete: Optional[Callable[[RequestHandle], None]] = None,
                 tracer=None, device: Optional[torch.device] = None):
        if combine not in ("mean", "weighted", "vote", "pallas"):
            raise ValueError(f"unknown combine rule {combine!r}")
        self.q = prediction_queue
        self.M = num_models
        self.combine = combine
        self.weights = (np.asarray(weights, np.float32) if weights is not None
                        else np.full(num_models, 1.0 / num_models, np.float32))
        if combine == "mean":
            self.weights = np.full(num_models, 1.0 / num_models, np.float32)
        self.timers = timers or StageTimers()
        self.on_complete = on_complete
        self.tracer = tracer
        # where the per-member 'pallas' fold runs its combine kernel
        self.device = torch.device("cpu") if device is None else device
        # ring cached once: rings are cleared in place, never replaced
        self._tr_ring = tracer.ring("accumulator") \
            if tracer is not None else None
        self.ready_count = 0
        self.oom = threading.Event()
        self.all_ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._requests: Dict[int, RequestHandle] = {}
        self._last: Optional[RequestHandle] = None
        self.data_messages = 0                # partials + per-member messages

    # ---- request lifecycle ----------------------------------------------------
    def begin(self, req: Request,
              on_segment: Optional[Callable] = None) -> RequestHandle:
        handle = RequestHandle(req, on_segment=on_segment)
        handle._canceller = self
        with self._lock:
            self._requests[req.rid] = handle
            self._last = handle
        if handle.remaining == 0:             # empty request
            self._finish(handle)
        return handle

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Legacy single-request helper: waits on the most recent begin()."""
        with self._lock:
            handle = self._last
        if handle is None:
            raise RuntimeError("no request in flight")
        return handle.result(timeout)

    def _finish(self, handle: RequestHandle,
                error: Optional[BaseException] = None) -> bool:
        # idempotent: completion can race cancel()/fail() from other threads,
        # and on_complete releases a BoundedSemaphore slot — exactly once.
        # The error is assigned under the same lock that claims the finish,
        # so a racing normal completion can't interleave with it.
        with self._lock:
            if handle._finished:
                return False
            handle._finished = True
            if error is not None:
                handle.error = error
            self._requests.pop(handle.req.rid, None)
        tr = self.tracer
        if isinstance(error, DeadlineExceeded):
            # deadline-miss rate feeds the brownout pressure signal (§11)
            self.timers.inc("deadline_misses")
            if tr is not None and tr.enabled:
                tr.instant("accumulator", "deadline_miss", rid=handle.req.rid)
                tr.note_deadline_miss()
        if error is None and handle.req.t_submit is not None:
            # per-class end-to-end latency (the hp_p50 SLO view, §7)
            lat = handle.latency_s = time.perf_counter() - handle.req.t_submit
            self.timers.latency(
                "high" if handle.req.priority == seg.PRIORITY_HIGH
                else "normal", lat)
            if tr is not None and tr.enabled:
                tr.instant("accumulator", "complete", rid=handle.req.rid,
                           args={"latency_ms": round(lat * 1e3, 3),
                                 "quality": round(handle.quality, 4)})
        elif error is not None and tr is not None and tr.enabled \
                and not isinstance(error, DeadlineExceeded):
            tr.instant("accumulator", "fail", rid=handle.req.rid,
                       args={"error": type(error).__name__})
        handle.done.set()
        if self.on_complete is not None:
            self.on_complete(handle)
        return True

    def fail(self, rid: int, error: BaseException) -> bool:
        """Resolve request ``rid`` with ``error`` (deadline expiry /
        cancellation).  Safe from any thread; returns False when the request
        already completed."""
        with self._lock:
            handle = self._requests.get(rid)
        if handle is None:
            return False
        done = self._finish(handle, error)
        if done and isinstance(error, RetriesExhausted):
            tr = self.tracer
            if tr is not None and tr.enabled:
                # freeze the flight recorder: the spans leading up to the
                # exhausted replay are exactly what a post-mortem needs
                tr.anomaly("retries_exhausted", f"request {rid}: {error}")
        return done

    # ---- the accumulation loop -------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._run, name="accumulator",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.q.put(None)
        if self._thread:
            self._thread.join(10.0)

    def _run(self):
        while True:
            msg = self.q.get()
            if msg is None:
                return
            if msg.s == seg.READY:
                self.ready_count += 1
                if self.ready_count >= self._expected_ready():
                    self.all_ready.set()
                continue
            if msg.s == seg.OOM and msg.m is None and msg.P is None:
                self.oom.set()
                with self._lock:
                    pending = list(self._requests.values())
                for h in pending:
                    self._finish(h, MemoryError(
                        "a worker reported OOM ({-1, None, None})"))
                continue
            if msg.s == seg.DROPPED and msg.P is None:
                # a batcher refused to pack rows for an expired/cancelled
                # request; resolve the future (idempotent across workers)
                self._drop(msg.rid)
                continue
            if msg.P is None:
                # forgiveness message (s >= 0, P=None, m = the dead member):
                # the member's sole instance was quarantined — complete the
                # request without these rows (DESIGN.md §10)
                self._degrade(msg)
                continue
            self._accumulate(msg)

    def _drop(self, rid: int) -> None:
        with self._lock:
            handle = self._requests.get(rid)
        if handle is None:
            return
        if handle.req.cancel_event.is_set():
            self._finish(handle, RequestCancelled(
                f"request {rid} cancelled"))
        else:
            self._finish(handle, DeadlineExceeded(
                f"request {rid} missed its deadline in the admission queue"))

    def _degrade(self, msg: Message) -> None:
        """Debit a dead member's rows for one segment without folding
        anything, tracking the missing combine weight for the
        completion-time renormalization.  The ``pallas`` combine cannot
        degrade — its fused kernel waits for ALL members' staged rows — so
        the request fails with :class:`MemberUnavailable` instead."""
        with self._lock:
            handle = self._requests.get(msg.rid)
        if handle is None:                    # stale (failed/completed)
            return
        req = handle.req
        if req.combine == "pallas":
            self._finish(handle, MemberUnavailable(
                f"member {msg.m} lost its last instance and the 'pallas' "
                f"combine needs every member's rows"))
            return
        lo, hi = req.bounds(msg.s)
        rows = hi - lo
        if handle._missing_w is None:
            handle._missing_w = np.zeros(req.n, np.float32)
        handle._missing_w[lo:hi] += req.weights.get(msg.m, 0.0)
        handle.degraded_rows += rows
        handle.remaining -= rows
        if handle._seg_remaining is not None:
            left = handle._seg_remaining[msg.s] - rows
            handle._seg_remaining[msg.s] = left
            if left == 0:
                # streaming edge (documented): a degraded segment's partial
                # fires with the raw (un-renormalized) rows — the final Y
                # from result() is renormalized, the stream is best-effort
                try:
                    handle.on_segment(msg.s, lo, hi, handle.Y[lo:hi])
                except Exception as e:
                    self._finish(handle, e)
                    return
        if handle.remaining == 0:
            self._complete(handle)

    def _complete(self, handle: RequestHandle) -> None:
        """All member-rows accounted for: renormalize any degraded rows over
        the members that did report, stamp the quality, and finish."""
        if handle.degraded_rows:
            req = handle.req
            mw = handle._missing_w
            mask = mw[:req.n] > 0
            if mask.any():
                # served weights summed to (1 - missing); dividing restores
                # a proper convex combination over the surviving members.
                # A row that lost every member keeps Y=0 (0 / eps) — its
                # weight mass is gone entirely.
                denom = np.maximum(1.0 - mw[:req.n][mask], 1e-12)
                handle.Y[mask] /= denom[:, None]
            total = req.n * len(req.members)
            # multiply, don't assign: a brownout-tier request enters with
            # quality = its tier's served weight fraction (< 1.0), and
            # mid-flight degradation/demotion compounds onto it.  For the
            # common full-quality entry (1.0 * x) this is bit-identical to
            # the old assignment.
            handle.quality *= 1.0 - handle.degraded_rows / max(total, 1)
            self.timers.inc("degraded_requests")
        self._finish(handle)

    _expected_ready_count = None

    def expect_ready(self, n: int):
        self._expected_ready_count = n
        if self.ready_count >= n:
            self.all_ready.set()

    def _expected_ready(self) -> int:
        return self._expected_ready_count or 1

    def _accumulate(self, msg: Message):
        t0 = time.perf_counter()
        with self._lock:
            handle = self._requests.get(msg.rid)
        if handle is None:                    # stale (timed-out/failed request)
            return
        req = handle.req
        if req.expired():                     # deadline enforcement (§7)
            self._finish(handle, DeadlineExceeded(
                f"request {req.rid} missed its deadline mid-flight"))
            return
        lo, hi = req.bounds(msg.s)
        self.data_messages += 1
        handle.messages += 1
        if msg.m is None:
            # device partial: weights already applied on-device; the combiner
            # flushes full segments, so this debits count x segment rows
            handle.Y[lo:hi] += msg.P
            rows = msg.count * (hi - lo)
        else:
            self._fold_member(handle, msg, lo, hi)
            rows = int(msg.P.shape[0])
        handle.remaining -= rows
        if handle._seg_remaining is not None:
            left = handle._seg_remaining[msg.s] - rows
            handle._seg_remaining[msg.s] = left
            if left == 0:                     # streaming partial: segment done
                try:
                    handle.on_segment(msg.s, lo, hi, handle.Y[lo:hi])
                except Exception as e:
                    # a raising client callback fails the request (through
                    # the idempotent finish — never by assigning error
                    # outside the lock) but must not kill this loop
                    self._finish(handle, e)
                    return
        t1 = time.perf_counter()
        self.timers.add("accumulate", t1 - t0)
        tr = self.tracer
        if tr is not None and tr.enabled:
            self._tr_ring.append(
                ("X", "accumulate", t0, t1 - t0, msg.rid,
                 msg.s, rows, None))
        if handle.remaining == 0:
            self._complete(handle)

    def _fold_member(self, handle: RequestHandle, msg: Message,
                     lo: int, hi: int):
        """Fold a per-member span message: rows ``[row_lo, row_lo+len(P))``
        of segment ``s``, i.e. request rows ``[lo+row_lo, ...)``."""
        req = handle.req
        w = req.weights[msg.m]
        a = lo + msg.row_lo
        b = a + int(msg.P.shape[0])
        if req.combine in ("mean", "weighted"):
            # the paper's one-liner: Y[start:end] += P / M (weighted form)
            handle.Y[a:b] += msg.P * w
        elif req.combine == "vote":
            onehot = np.zeros_like(handle.Y[a:b])
            onehot[np.arange(b - a), msg.P.argmax(axis=1)] = w
            handle.Y[a:b] += onehot
        elif req.combine == "pallas":
            # spans buffer into per-(segment, member) staging rows; the fused
            # kernel runs once all members' rows for the segment are present.
            # Whole-segment messages (the common case — senders reassemble
            # spans) store by reference instead of paying an alloc + copy.
            buf = handle._seg_buffers.setdefault(msg.s, {})
            if msg.row_lo == 0 and msg.P.shape[0] == hi - lo:
                buf[msg.m] = msg.P
            else:
                arr = buf.get(msg.m)
                if arr is None:
                    arr = buf[msg.m] = np.zeros((hi - lo, req.num_classes),
                                                np.float32)
                arr[msg.row_lo:msg.row_lo + msg.P.shape[0]] = msg.P
            got = self._seg_rows_add(handle, msg.s, int(msg.P.shape[0]))
            if got == (hi - lo) * len(req.members):
                from repro_torch.kernels import ops as kops
                stacked = torch.from_numpy(
                    np.stack([buf[m] for m in req.members])).to(self.device)
                wv = torch.tensor([req.weights[m] for m in req.members],
                                  dtype=torch.float32, device=self.device)
                handle.Y[lo:hi] = kops.ensemble_combine(
                    stacked, wv).cpu().numpy()
                del handle._seg_buffers[msg.s]
                del handle._seg_rows[msg.s]
        else:
            raise ValueError(f"unknown combine rule {req.combine!r}")

    @staticmethod
    def _seg_rows_add(handle: RequestHandle, s: int, rows: int) -> int:
        got = handle._seg_rows.get(s, 0) + rows
        handle._seg_rows[s] = got
        return got
