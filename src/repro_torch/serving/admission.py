"""Two-level priority queues for the worker pipeline (DESIGN.md §§3/7).

:class:`AdmissionQueue` (ROADMAP item a) is the worker batcher's input
queue: latency-sensitive requests must not wait behind a bulk scan, so
admission is class-based instead of strict FIFO — ``PRIORITY_HIGH``
descriptors drain before ``PRIORITY_NORMAL`` ones, FIFO *within* each class
(no reordering among equals, so the sender's row-count span reassembly
stays trivially correct: all of one segment's spans are packed in one
batcher iteration either way).

:class:`DispatchQueue` (ROADMAP items e/k) sits *between the batcher and
the predictor*: a flushed slot's compiled chunks enter it as independently
schedulable :class:`~repro_torch.serving.segments.ChunkDesc` units, classed by
:func:`chunk_level`, so a high-priority chunk jumps queued bulk chunks
instead of waiting for up to ``RING_SLOTS`` already-flushed slots.  Only
the single chunk already dispatched to the device (plus the dispatch-ahead
window) is non-preemptible.

The interface mirrors the ``queue.Queue`` subset the consumers use
(``put`` / ``get(timeout)`` / ``get_nowait`` / ``qsize``) so control
sentinels (``SHUTDOWN`` / ``FLUSH`` / barriers) flow through unchanged at
normal priority.  Starvation is not a concern at this queue's time scale:
high priority is meant for sparse latency-sensitive traffic, and a
saturating high-priority flood is an admission-control problem upstream of
the worker.
"""
from __future__ import annotations

import heapq
import queue
import threading
from collections import deque
from typing import Optional, Sequence

from repro_torch.serving.segments import (PRIORITY_HIGH, PRIORITY_NORMAL,
                                    ChunkDesc, Span, priority_level)


def chunk_level(spans: Sequence[Span]) -> int:
    """Dispatch class of a chunk: the most urgent priority among the
    requests whose spans it carries (reusing the admission
    ``priority_level`` scale, where lower = more urgent).  A bulk chunk
    that coalesced even one high-priority request's rows dispatches at high
    priority — holding those rows back would defeat the preemption."""
    level = PRIORITY_NORMAL
    for sp in spans:
        level = min(level, priority_level(sp.req.priority))
        if level == PRIORITY_HIGH:
            break
    return level


class AdmissionBudget:
    """Bounded global byte/row budget for admitted-but-unfinished work
    (DESIGN.md §11 backpressure).

    The admission queues themselves stay unbounded (sentinels and control
    items must never block), but the *request payloads* feeding them are
    charged here at admission and credited back at completion, so queue
    memory cannot grow without bound under sustained overload: once the
    budget is exhausted new requests fail fast with
    :class:`~repro_torch.serving.segments.Overloaded` (HTTP 429) instead of
    piling onto a queue they would only time out in.  ``rows`` counts
    request rows x planned members — the same unit the accumulator debits —
    so the row budget bounds pipeline work, while the byte budget bounds
    input-buffer memory."""

    def __init__(self, max_bytes: Optional[int] = None,
                 max_rows: Optional[int] = None):
        self.max_bytes = max_bytes
        self.max_rows = max_rows
        self._lock = threading.Lock()
        self.bytes_used = 0
        self.rows_used = 0
        self.rejected = 0

    def try_charge(self, nbytes: int, rows: int) -> bool:
        """Atomically charge, or refuse without side effects.  A single
        request larger than the whole budget is still admitted when the
        budget is idle (otherwise it could never run)."""
        with self._lock:
            idle = self.bytes_used == 0 and self.rows_used == 0
            over_b = self.max_bytes is not None and \
                self.bytes_used + nbytes > self.max_bytes
            over_r = self.max_rows is not None and \
                self.rows_used + rows > self.max_rows
            if (over_b or over_r) and not idle:
                self.rejected += 1
                return False
            self.bytes_used += nbytes
            self.rows_used += rows
            return True

    def credit(self, nbytes: int, rows: int) -> None:
        with self._lock:
            self.bytes_used = max(0, self.bytes_used - nbytes)
            self.rows_used = max(0, self.rows_used - rows)

    def snapshot(self) -> dict:
        with self._lock:
            return {"bytes_used": self.bytes_used,
                    "rows_used": self.rows_used,
                    "max_bytes": self.max_bytes,
                    "max_rows": self.max_rows,
                    "rejected": self.rejected}


class AdmissionQueue:
    """Unbounded two-level MPSC queue with ``queue.Queue``-style blocking.

    ``trace_hook`` (optional, wired by the system when tracing is on) is
    called as ``hook(kind, items, level)`` after batch transitions —
    ``"enqueue"`` on :meth:`put_many`, ``"steal"`` / ``"drain"`` after
    work moves between workers — so the tracer can annotate timelines
    with queue-level control-plane facts.  Hooks run outside the queue
    lock; when unset the cost is one attribute check."""

    trace_hook = None

    def __init__(self):
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._levels = {PRIORITY_HIGH: deque(), PRIORITY_NORMAL: deque()}

    def put(self, item, priority: int = PRIORITY_NORMAL) -> None:
        with self._not_empty:
            self._levels[priority].append(item)
            self._not_empty.notify()

    def put_many(self, items, priority: int = PRIORITY_NORMAL) -> None:
        """Enqueue a batch of items at one level under ONE lock acquisition
        (the batcher flushes a slot's chunks together — per-item locking
        would multiply queue overhead by chunks-per-slot)."""
        if not items:
            return
        with self._not_empty:
            self._levels[priority].extend(items)
            self._not_empty.notify()
        hook = self.trace_hook
        if hook is not None:
            hook("enqueue", items, priority)

    def _pop(self):
        for level in (PRIORITY_HIGH, PRIORITY_NORMAL):
            q = self._levels[level]
            if q:
                return q.popleft()
        raise queue.Empty

    def get(self, timeout: Optional[float] = None):
        with self._not_empty:
            if timeout is None:
                while not self._size_locked():
                    self._not_empty.wait()
            elif not self._not_empty.wait_for(self._size_locked, timeout):
                raise queue.Empty
            return self._pop()

    def get_nowait(self):
        with self._lock:
            return self._pop()

    def take_high(self):
        """Atomically pop the head HIGH-priority *descriptor*, or return
        None when the high class is empty or its head is not a descriptor
        tuple.  The batcher's preemptible bulk-slot wait uses this: a bare
        depth-check-then-get would race ``drain_descriptors`` (drain-side
        migration empties BOTH classes under the queue lock) and either
        raise Empty or swallow a sentinel the batcher still owes an ack
        for."""
        with self._lock:
            q = self._levels[PRIORITY_HIGH]
            if q and isinstance(q[0], tuple):
                return q.popleft()
            return None

    def get_batch(self, max_items: int):
        """Block for the first item, then pop up to ``max_items`` under ONE
        lock acquisition, strictly in priority order (all available high
        items drain before any normal one).  The consumer-side twin of
        :meth:`put_many`: per-item locking on a hot hand-off path costs a
        contended lock round per item for no scheduling benefit when the
        caller is about to commit the whole batch anyway."""
        with self._not_empty:
            while not self._size_locked():
                self._not_empty.wait()
            out = []
            while len(out) < max_items and self._size_locked():
                out.append(self._pop())
            return out

    def _size_locked(self) -> int:
        return len(self._levels[PRIORITY_HIGH]) + \
            len(self._levels[PRIORITY_NORMAL])

    def qsize(self) -> int:
        with self._lock:
            return self._size_locked()

    def steal(self, max_items: int) -> list:
        """Pop up to ``max_items`` normal-priority segment descriptors from
        the stealable tail region (DESIGN.md §8: cross-worker work
        stealing).  The sweep walks tail-ward until it meets a
        non-descriptor item and stops there: it can only take descriptors
        enqueued *after* the last sentinel, and a queue whose tail IS a
        sentinel (``SHUTDOWN`` / ``FLUSH`` just posted — the worker is
        draining or being quiesced) yields nothing.  Sentinels themselves
        are never popped or reordered, and the victim's head — what its
        batcher is about to drain — is never contended.

        Within the stealable region selection is **deadline-aware** (ROADMAP
        item i): descriptors whose requests have the tightest remaining
        deadline budget are picked first — they gain the most from the idle
        sibling — and deadline-less descriptors rank loosest, newest first
        (the work that would otherwise wait longest, the classic tail-steal
        order).  The returned list drains tightest-deadline work first
        (FIFO among equals), so re-putting at the destination serves urgent
        work soonest.  Atomic with respect to the consumer: a descriptor is
        owned either by the thief or by the batcher, never both."""
        with self._lock:
            q = self._levels[PRIORITY_NORMAL]
            first = len(q)
            any_deadline = False
            while first > 0 and isinstance(q[first - 1], tuple):
                first -= 1
                if getattr(q[first][0], "deadline", None) is not None:
                    any_deadline = True
            if first == len(q):
                return []
            if not any_deadline:
                # common case (bulk work carries no deadlines): the classic
                # O(max_items) tail pop — no sort, no region rebuild, and
                # the victim's batcher contends this lock on its hot path
                stolen = []
                while q and len(stolen) < max_items and \
                        isinstance(q[-1], tuple):
                    stolen.append(q.pop())
                stolen.reverse()
                return self._stolen(stolen)

            def urgency(i):          # (no-deadline flag, deadline) ascending
                d = getattr(q[i][0], "deadline", None)
                return (d is None, d or 0.0)

            chosen = heapq.nsmallest(max_items, range(first, len(q)),
                                     key=lambda i: urgency(i) + (-i,))
            chosen.sort(key=lambda i: urgency(i) + (i,))
            stolen = [q[i] for i in chosen]
            take = set(chosen)
            kept = [q[i] for i in range(first, len(q)) if i not in take]
            for _ in range(len(q) - first):
                q.pop()
            q.extend(kept)
        return self._stolen(stolen)

    def _stolen(self, stolen: list) -> list:
        hook = self.trace_hook
        if hook is not None and stolen:
            hook("steal", stolen, None)
        return stolen

    def drain_descriptors(self) -> list:
        """Pop EVERY queued segment descriptor, both priority classes
        (drain-side instance migration — unlike :meth:`steal`, a retiring
        worker's latency-sensitive work must move too, or exactly the
        high-priority class would pay the victim's full drain latency).
        High-priority descriptors first, FIFO within each class; re-putting
        with each request's own priority restores class order at the
        destination.  Sentinels (``SHUTDOWN``/``FLUSH``/barriers) stay in
        place in their relative order — the retiring batcher still owes
        their acknowledgements."""
        out = []
        with self._lock:
            for level in (PRIORITY_HIGH, PRIORITY_NORMAL):
                keep = deque()
                for item in self._levels[level]:
                    (out if isinstance(item, tuple) else keep).append(item)
                self._levels[level] = keep
        hook = self.trace_hook
        if hook is not None and out:
            hook("drain", out, None)
        return out

    def depth(self, priority: int) -> int:
        """Backlog of one class (the ``queue_depth.<worker>`` gauge uses
        ``qsize``; per-class depth feeds tests and adaptive linger)."""
        with self._lock:
            return len(self._levels[priority])


class DispatchQueue(AdmissionQueue):
    """The per-worker chunk dispatch queue between batcher and predictor
    (DESIGN.md §3): items are :class:`~repro_torch.serving.segments.ChunkDesc`
    units ``put`` at their :func:`chunk_level` class — high-priority chunks
    jump queued bulk chunks, FIFO within a class — plus pipeline control
    items at normal priority (``None`` shutdown sentinel, ``FlushBarrier``
    acknowledged by the predictor once every previously-flushed chunk has
    been dispatched).  Chunks are never stolen or migrated: their rows are
    already packed into this worker's ring slots, so re-routing happens one
    stage earlier, on the :class:`AdmissionQueue`."""

    def steal(self, max_items: int) -> list:
        raise TypeError("chunks are bound to their worker's ring slots; "
                        "steal from the AdmissionQueue instead")

    def drain_descriptors(self) -> list:
        raise TypeError("chunks are bound to their worker's ring slots; "
                        "migrate AdmissionQueue descriptors instead")


def chunk_deadline(chunk: ChunkDesc) -> float:
    """Earliest absolute deadline among the requests whose spans the chunk
    carries; +inf when none of them has one."""
    d = float("inf")
    for sp in chunk.spans:
        rd = sp.req.deadline
        if rd is not None and rd < d:
            d = rd
    return d


class EDFDispatchQueue(DispatchQueue):
    """Earliest-deadline-first chunk dispatch (ROADMAP item m, prototype).

    Replaces the two static dispatch classes with a single heap ordered by
    ``(chunk deadline, chunk_level, enqueue seq)``: the chunk whose
    tightest-deadline request expires soonest dispatches first; deadline
    ties fall back to the existing priority classes, then FIFO.
    Deadline-less chunks rank at +inf, so a pure two-class workload behaves
    exactly like :class:`DispatchQueue` (the EDF order degenerates to
    class-then-FIFO) — EDF only changes behavior when deadlines actually
    differentiate the backlog.

    Control items (the ``None`` shutdown sentinel, ``FlushBarrier``) keep
    FIFO order in a side lane and are released only once every queued chunk
    has dispatched — a conservative barrier: EDF may reorder chunks
    *between* flushes, so a barrier that overtook a reordered chunk would
    acknowledge a flush that has not fully dispatched yet.

    Status: validated in the simulator (DESIGN.md §12; `sim.edf` bench
    gate) and wired into the live Worker behind
    ``--dispatch-queue edf`` (``InferenceSystem(dispatch_queue="edf")``);
    the live default remains :class:`DispatchQueue` (FIFO within
    priority class)."""

    def __init__(self):
        super().__init__()
        self._eheap = []                      # (deadline, level, seq, chunk)
        self._eseq = 0
        self._control = deque()

    def _push_locked(self, item) -> None:
        if isinstance(item, ChunkDesc):
            self._eseq += 1
            heapq.heappush(self._eheap, (chunk_deadline(item), item.level,
                                         self._eseq, item))
        else:
            self._control.append(item)

    def put(self, item, priority: int = PRIORITY_NORMAL) -> None:
        with self._not_empty:
            self._push_locked(item)
            self._not_empty.notify()

    def put_many(self, items, priority: int = PRIORITY_NORMAL) -> None:
        if not items:
            return
        with self._not_empty:
            for item in items:
                self._push_locked(item)
            self._not_empty.notify()
        hook = self.trace_hook
        if hook is not None:
            hook("enqueue", items, priority)

    def _pop(self):
        if self._eheap:
            return heapq.heappop(self._eheap)[3]
        if self._control:
            return self._control.popleft()
        raise queue.Empty

    def _size_locked(self) -> int:
        return len(self._eheap) + len(self._control)

    def depth(self, priority: int) -> int:
        with self._lock:
            if priority == PRIORITY_HIGH:
                return sum(1 for e in self._eheap
                           if e[1] == PRIORITY_HIGH)
            return len(self._eheap) + len(self._control) - sum(
                1 for e in self._eheap if e[1] == PRIORITY_HIGH)

    def take_high(self):
        return None                 # no side lane to express-pop from
