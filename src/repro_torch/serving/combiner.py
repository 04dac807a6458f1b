"""Device-resident partial ensemble combine (DESIGN.md §4).

Workers co-located on one device fold their weighted predictions into a
shared per-(request, segment) partial *on the device* and post **one**
``Message(s, None, partial, rid, count)`` per device per segment — instead of
one {s, m, P} message (and one device->host transfer) per member.  With M
members sharing a device this cuts accumulator traffic by up to M×.

How the flush trigger stays deterministic under coalescing: the broadcaster
assigns every (segment, model) pair to a *specific* worker instance
(round-robin striping across data-parallel instances, system.py), so at
``begin()`` time the system knows exactly how many member contributions each
device will produce for each segment.  The coalescing batcher may split one
member's segment across several batches, so contributions arrive as
row-ranges — the combiner therefore counts **rows, not messages**: a segment
flushes the moment ``members_on_device × segment_rows`` rows have been
folded, which is reached exactly once however the spans were packed.

Early-forward audit (chunk-granular pipeline, DESIGN.md §3): senders now
forward a (request, segment) the moment its last chunk materializes —
before the slot retires, and under priority reordering possibly *out of
segment order* and interleaved arbitrarily across members.  The row
arithmetic above is already order-free (each (segment, member) contributes
its rows exactly once, whenever it arrives), so nothing here changes; the
same holds for the `unexpect`/`expect_one` steal migration, which operates
on counts, not arrival order.

Combination rules are applied member-side, so the partial is always additive:
  mean/weighted  partial[lo:hi] += w_m · P_m[lo:hi]
  vote           partial[lo:hi] += w_vote · onehot(argmax P_m[lo:hi])
  pallas         partial[lo:hi]  = ensemble_combine(P_m[None], [w_m],
                 partial[lo:hi]) — the accumulate-into-partial kernel,
                 applied to the span's rows
and the accumulator's per-message work collapses to ``Y[lo:hi] += partial``.

The device partial is a tensor on the member's device.  The accumulate
kernels write their result straight into ``partial[lo:hi]`` (each element is
read before it is written), so a fold allocates nothing.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.segments import Message, Request


class _SegPartial:
    __slots__ = ("acc", "rows")

    def __init__(self):
        self.acc = None        # np.ndarray or device-resident tensor
        self.rows = 0          # member-rows folded so far


class DeviceCombiner:
    """One per device hosting >= 1 worker.  ``add()`` is called from worker
    sender threads; a per-combiner lock serializes the fold bookkeeping (the
    device math itself is dispatched asynchronously)."""

    def __init__(self, name: str, prediction_queue: "queue.Queue[Message]",
                 timers: Optional[StageTimers] = None, tracer=None):
        self.name = name
        self.prediction_queue = prediction_queue
        self.timers = timers
        self.tracer = tracer
        self._tr_track = f"combine.{name}"
        # ring cached once: rings are cleared in place, never replaced
        self._tr_ring = tracer.ring(self._tr_track) \
            if tracer is not None else None
        self._lock = threading.Lock()
        # rid -> {s: (member contributions, expected member-rows)}
        self._expected: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self._parts: Dict[Tuple[int, int], _SegPartial] = {}
        self.partials_posted = 0

    # ---- request lifecycle ---------------------------------------------------
    def begin(self, req: Request, expected: Dict[int, int]) -> None:
        """Register how many member contributions each segment of ``req``
        will see on this device.  The flush trigger is row-based: segment
        ``s`` completes after ``expected[s] * (end(s)-start(s))`` rows."""
        with self._lock:
            self._expected[req.rid] = {
                s: (n, n * (req.bounds(s)[1] - req.bounds(s)[0]))
                for s, n in expected.items() if n}

    def finish(self, rid: int) -> None:
        """Drop any state for a completed/failed request (idempotent)."""
        with self._lock:
            self._expected.pop(rid, None)
            for key in [k for k in self._parts if k[0] == rid]:
                del self._parts[key]

    # ---- expected-map migration (work stealing, DESIGN.md §8) ----------------
    def unexpect(self, req: Request, s: int) -> bool:
        """Remove ONE expected member contribution for (``req``, ``s``) — the
        inverse of one unit of :meth:`begin` — because its queued descriptor
        was re-routed to a data-parallel sibling on another device.  Returns
        False when the request is no longer tracked here (completed or torn
        down), in which case the caller must not register the expectation
        elsewhere.  If other members' rows already closed the reduced row
        count, the partial flushes immediately — exactly the message the
        accumulator would have seen had the stolen member never been striped
        to this device."""
        flush = None
        with self._lock:
            expected = self._expected.get(req.rid)
            if expected is None or s not in expected:
                return False
            count, want_rows = expected[s]
            lo, hi = req.bounds(s)
            count -= 1
            want_rows -= hi - lo
            part = self._parts.get((req.rid, s))
            if count <= 0:
                # no member left on this device: nothing can have been folded
                # (each (segment, member) routes to exactly one instance)
                self._parts.pop((req.rid, s), None)
                del expected[s]
            elif part is not None and part.rows >= want_rows:
                flush = (part, count)
                del self._parts[(req.rid, s)]
                del expected[s]
            else:
                expected[s] = (count, want_rows)
            if not expected:
                del self._expected[req.rid]
        if flush is not None:
            self._post(req.rid, s, *flush)
        return True

    def expect_one(self, req: Request, s: int) -> None:
        """Register one additional expected member contribution for
        (``req``, ``s``) — the destination side of a stolen descriptor."""
        lo, hi = req.bounds(s)
        with self._lock:
            expected = self._expected.setdefault(req.rid, {})
            count, want_rows = expected.get(s, (0, 0))
            expected[s] = (count + 1, want_rows + (hi - lo))

    # ---- the fold ------------------------------------------------------------
    def add(self, req: Request, s: int, m: int, P, row_lo: int = 0) -> None:
        """Fold member ``m``'s rows ``[row_lo, row_lo+len(P))`` of segment
        ``s`` into the device partial; post the partial once the segment's
        expected row count is reached.  ``P`` may be a numpy array (fake
        workers) or a device array — device arrays stay resident until the
        single flush transfer."""
        t0 = time.perf_counter()
        flush = None
        # quantized members forward (q, per-row scale) tuples
        nrows = int(P[0].shape[0]) if isinstance(P, tuple) else int(P.shape[0])
        # the heavy elementwise math runs outside the lock; only the
        # accumulate + bookkeeping is serialized
        contrib = self._contribution(req, P, req.weights[m])
        with self._lock:
            expected = self._expected.get(req.rid)
            if expected is None or s not in expected:   # request torn down
                return
            part = self._parts.setdefault((req.rid, s), _SegPartial())
            part.acc = self._fold(req, part.acc, contrib, req.weights[m],
                                  s, row_lo)
            part.rows += nrows
            count, want_rows = expected[s]
            if part.rows >= want_rows:
                flush = (part, count)
                del self._parts[(req.rid, s)]
                del expected[s]
                if not expected:
                    del self._expected[req.rid]
        if flush is not None:
            self._post(req.rid, s, *flush)
        t1 = time.perf_counter()
        if self.timers is not None:
            self.timers.add("combine", t1 - t0)
        tr = self.tracer
        if tr is not None and tr.enabled:
            self._tr_ring.append(
                ("X", "combine", t0, t1 - t0, req.rid,
                 s, m, flush is not None))

    def _post(self, rid: int, s: int, part: _SegPartial, count: int) -> None:
        """The single device->host transfer per device per segment."""
        acc = part.acc
        if isinstance(acc, torch.Tensor):
            acc = acc.cpu().numpy()
        self.prediction_queue.put(Message(s, None, acc, rid=rid, count=count))
        self.partials_posted += 1

    @staticmethod
    def _contribution(req: Request, P, w: float):
        """Member's additive contribution (weighted prediction / vote).  For
        the pallas rule the raw device array passes through: the weighting is
        fused into the accumulate kernel at fold time.  Quantized members
        forward ``(q, per-row scale)`` tuples — pallas defers dequantization
        to the fused epilogue kernel; vote uses ``q`` directly (the per-row
        scale is positive and uniform across classes, so argmax is
        preserved); mean/weighted dequantize here."""
        if isinstance(P, tuple):
            if req.combine == "pallas":
                return P
            from repro_torch.kernels import quant as kq
            P = P[0] if req.combine == "vote" else kq.dequantize(P[0], P[1])
        if req.combine == "vote":
            if isinstance(P, np.ndarray):
                contrib = np.zeros((P.shape[0], req.num_classes), np.float32)
                contrib[np.arange(P.shape[0]), P.argmax(axis=1)] = w
                return contrib
            return w * torch.nn.functional.one_hot(
                P.argmax(dim=-1), req.num_classes).float()
        if req.combine == "pallas" and not isinstance(P, np.ndarray):
            return P
        # mean / weighted (and pallas with host arrays from fake workers)
        return P * np.float32(w)

    @staticmethod
    def _fold(req: Request, acc, contrib, w: float, s: int, row_lo: int):
        """Fold a span contribution into the full-segment partial at its row
        offset.  The partial is allocated once per (request, segment) at the
        segment's full row count, host- or device-side matching the first
        contribution."""
        lo, hi = req.bounds(s)
        seg_rows = hi - lo
        quant = isinstance(contrib, tuple)     # (q, per-row scale) pair
        a = row_lo
        b = row_lo + int(contrib[0].shape[0] if quant else contrib.shape[0])
        if not quant and isinstance(contrib, np.ndarray):
            if acc is None:
                acc = np.zeros((seg_rows, req.num_classes), np.float32)
            acc[a:b] += contrib                # in-place: no temp per fold
            return acc
        if acc is None:
            acc = torch.zeros((seg_rows, req.num_classes), dtype=torch.float32,
                              device=(contrib[0] if quant else contrib).device)
        if req.combine == "pallas":
            from repro_torch.kernels import ops as kops
            wv = torch.full((1,), w, dtype=torch.float32, device=acc.device)
            part = acc[a:b]
            if quant:
                # fused dequant-weight-accumulate epilogue: q stays in its
                # narrow storage dtype all the way into the kernel
                q, scale = contrib
                kops.ensemble_accumulate_quant(part, q[None],
                                               scale.reshape(1, -1), wv,
                                               out=part)
            else:
                # the accumulate-into-partial kernel, on the span, in place
                kops.ensemble_accumulate(part, contrib[None].float(), wv,
                                         out=part)
            return acc
        acc[a:b] += contrib
        return acc
