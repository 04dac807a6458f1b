"""Segment protocol (paper §II.C.1) and the per-request descriptor.

Requests are split into fixed-size segments; only small descriptors flow
through the FIFO queues while the sample bytes live in the request's input
buffer.  Special ids: ``SHUTDOWN`` asks a worker to exit, ``FLUSH`` asks its
batcher to close any partially-filled coalesced batch immediately (quiesce);
workers emit ``Message(OOM/READY, ...)`` sentinels to the prediction
accumulator.

Hot-path extensions (DESIGN.md §3):
  * every in-flight request owns a :class:`Request` descriptor carrying a
    *versioned* input buffer — a new request never reallocates a buffer a
    worker may still be reading (the seed's ``shared_x`` swap race);
  * messages are tagged with the request id ``rid`` so multiple requests can
    be in flight at once;
  * a message with ``m is None`` is a *device partial*: the weighted sum of
    ``count`` member predictions, pre-combined on one device
    (DESIGN.md §4) — the accumulator just adds it into Y;
  * under the coalescing scheduler one compiled batch carries rows from
    *multiple* (request, segment) pairs — a :class:`Span` is one contiguous
    row-range of one segment inside one batch, and a batch's span list is
    the *scatter descriptor* the sender walks to route output rows back to
    their requests.  A segment's rows may therefore arrive split across
    several messages: ``Message.row_lo`` locates a message's rows inside the
    segment, and downstream accounting counts **rows, not messages**.

Request API (DESIGN.md §7): a :class:`PredictOptions` descriptor expresses
per-request intent — priority class, deadline, member subset, combine rule,
cache policy, streaming — and rides on the :class:`Request`, so every stage
(admission queue, batcher, combiner, accumulator) can honor it.  A batcher
that pops a descriptor whose request is cancelled or past its deadline posts
``Message(DROPPED, ...)`` instead of packing rows; the accumulator turns that
into a :class:`DeadlineExceeded` / :class:`RequestCancelled` result.

Chunk granularity (DESIGN.md §3): a flushed slot is no longer indivisible —
the batcher cuts it into its compiled chunks and each becomes a
:class:`ChunkDesc`, the unit the per-worker dispatch queue schedules (a
high-priority chunk jumps queued bulk chunks).  A :class:`SlotRef` carries
the slot's outstanding-chunk refcount: the ring buffer recycles only after
EVERY chunk's output is materialized (on CPU ``device_put`` may alias host
memory, so one chunk retiring early must not free rows another chunk still
reads).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

SHUTDOWN = -1          # segment-ids-queue sentinel: worker must exit
FLUSH = -3             # segment-ids-queue sentinel: flush open coalesced batch
OOM = -1               # prediction-queue sentinel: device out of memory
READY = -2             # prediction-queue sentinel: worker initialized
DROPPED = -4           # prediction-queue sentinel: batcher dropped an
                       # expired/cancelled request's segment (carries rid)

DEFAULT_SEGMENT_SIZE = 128      # paper §III: fixed to 128

# admission priority classes (index into the two-level admission queue;
# lower value = drained first)
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
_PRIORITY_NAMES = {"high": PRIORITY_HIGH, "normal": PRIORITY_NORMAL}


class FlushBarrier:
    """An acknowledged FLUSH: the batcher closes any open coalesced slot and
    then sets ``done``.  ``InferenceSystem.quiesce(wait=True)`` and the
    reconfiguration controller's drain path use it as a barrier — unlike the
    fire-and-forget ``FLUSH`` int, the caller can block until every batcher
    has actually processed the flush (DESIGN.md §8)."""
    __slots__ = ("done",)

    def __init__(self):
        self.done = threading.Event()


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its prediction completed."""


class RequestCancelled(Exception):
    """The request was cancelled via ``RequestHandle.cancel()``."""


class ServingUnavailable(RuntimeError):
    """Base of the transient-capacity failure taxonomy (DESIGN.md §10).

    Unlike :class:`DeadlineExceeded` (the request was too slow) these mean
    the *system* momentarily lacks the capacity to serve the request — the
    HTTP layer maps them to 503 + ``Retry-After`` so clients retry instead
    of treating them as permanent errors."""


class Overloaded(ServingUnavailable):
    """The system refused the request at admission: serving it within its
    deadline (or within the global admission byte/row budget) is infeasible
    at the current pressure (DESIGN.md §11).  Raised *before* any pipeline
    resources are consumed, so the caller can retry elsewhere immediately —
    the HTTP layer maps it to 429 with a ``Retry-After`` computed from the
    current drain estimate."""

    def __init__(self, msg: str = "overloaded",
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class WorkerCrashed(ServingUnavailable):
    """A worker stage thread died (or stalled past the watchdog) while the
    request had work on it and recovery could not complete it."""


class MemberUnavailable(ServingUnavailable):
    """An ensemble member the request needs has no live instance (its last
    worker was quarantined and the respawn has not landed yet)."""


class RetriesExhausted(ServingUnavailable):
    """The request's chunk-replay budget ran out: its work was resubmitted
    after worker failures more times than ``retry_budget`` allows."""


def priority_level(priority) -> int:
    """Normalize a priority spec ("high"/"normal" or the int constants)."""
    if isinstance(priority, str):
        try:
            return _PRIORITY_NAMES[priority]
        except KeyError:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(expected one of {sorted(_PRIORITY_NAMES)})")
    p = int(priority)
    if p != priority or p not in (PRIORITY_HIGH, PRIORITY_NORMAL):
        raise ValueError(f"priority must be high ({PRIORITY_HIGH}) or "
                         f"normal ({PRIORITY_NORMAL}), got {priority!r}")
    return p


@dataclass(frozen=True)
class PredictOptions:
    """Per-request intent, threaded end-to-end through :class:`Request`.

    ``priority``     admission class: "high" requests drain before "normal"
                     ones (FIFO within a class) and preempt the coalescing
                     linger;
    ``deadline_ms``  relative deadline: the request fails fast with
                     :class:`DeadlineExceeded` once it expires — at
                     admission, at the batcher (rows are never packed), and
                     at the accumulator;
    ``members``      ensemble-member subset (paper §I.B "ensemble
                     selection"); None = all members;
    ``combine``      per-request combine rule (mean/weighted/vote/pallas);
                     None = the system default;
    ``cache``        prediction-cache policy for clients holding a cache:
                     "use" (lookup + fill), "bypass" (skip the cache) or
                     "refresh" (recompute and overwrite);
    ``stream``       per-segment streaming: ``on_segment(s, lo, hi, Y_seg)``
                     fires as each segment's ensemble rows complete (set
                     automatically by ``EnsembleClient.predict_stream``);
    ``member_dtype`` minimum member execution precision (DESIGN.md §14):
                     restricts the request to members running at this
                     precision *or better* (fp32 > bf16 > int8/fp8) — e.g.
                     "fp32" excludes quantized members for an
                     accuracy-critical request; None = any precision.
    """
    priority: object = "normal"
    deadline_ms: Optional[float] = None
    members: Optional[Sequence[int]] = None
    combine: Optional[str] = None
    cache: str = "use"
    stream: bool = False
    on_segment: Optional[Callable] = None
    member_dtype: Optional[str] = None

    def __post_init__(self):
        priority_level(self.priority)       # validate eagerly
        if self.cache not in ("use", "bypass", "refresh"):
            raise ValueError(f"unknown cache policy {self.cache!r}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        if self.member_dtype is not None:
            from repro_torch.kernels.quant import validate_member_dtype
            validate_member_dtype(self.member_dtype)

    def level(self) -> int:
        return priority_level(self.priority)

    def deadline_at(self, now: Optional[float] = None) -> Optional[float]:
        """Absolute ``perf_counter`` deadline, fixed at admission time."""
        if self.deadline_ms is None:
            return None
        return (time.perf_counter() if now is None else now) \
            + self.deadline_ms * 1e-3


def num_segments(nb_samples: int, segment_size: int) -> int:
    return (nb_samples + segment_size - 1) // segment_size


def start(s: int, segment_size: int) -> int:
    return s * segment_size


def end(s: int, segment_size: int, nb_samples: int) -> int:
    return min((s + 1) * segment_size, nb_samples)


@dataclass
class Message:
    """The {s, m, P} triplet (paper §II.C.2), tagged with the request id.

    ``m is None`` (with ``s >= 0``) marks a device-partial message whose P
    already folds ``count`` weighted member predictions.  Under coalescing a
    per-member message may carry only a row-range of its segment: ``P`` then
    covers segment rows ``[row_lo, row_lo + len(P))`` and the accumulator
    debits rows, not messages.  Sentinels use P=None."""
    s: int                       # segment id (or OOM / READY)
    m: Optional[int]             # model id; None = device partial
    P: Optional[np.ndarray]      # (rows, C) prediction matrix
    rid: int = 0                 # request id
    count: int = 1               # member contributions folded into P
    row_lo: int = 0              # first segment row covered by P

    @property
    def is_sentinel(self) -> bool:
        return self.s < 0


@dataclass
class Request:
    """One in-flight predict() call.

    ``x`` is the request's own input buffer (rows ``[:n]`` valid).  Workers
    slice it zero-copy; because the buffer belongs to the request — not the
    system — growing a later request can never invalidate it mid-flight.

    ``priority``/``deadline`` come from :class:`PredictOptions` and are read
    by every pipeline stage; ``cancel_event`` is set by
    ``RequestHandle.cancel()`` so batchers can drop still-queued descriptors
    instead of packing rows for a dead request."""
    rid: int
    x: np.ndarray                       # (capacity >= n, seq) int32
    n: int                              # valid samples
    num_classes: int
    segment_size: int
    members: List[int]                  # active ensemble members
    weights: Dict[int, float]           # member -> normalized combine weight
    combine: str = "mean"
    priority: int = PRIORITY_NORMAL
    deadline: Optional[float] = None    # absolute perf_counter seconds
    t_submit: Optional[float] = None    # admission time (perf_counter)
    retries: int = 0                    # quarantine replays charged so far
    cancel_event: threading.Event = field(default_factory=threading.Event,
                                          repr=False, compare=False)
    # Members demoted mid-flight by the brownout controller (DESIGN.md §11).
    # Mutated only by set.add (GIL-atomic); stages treat membership as
    # advisory — a unit that raced past the check is simply served, the
    # accounting closes either way.  Unlike ``cancel_event`` a demoted
    # member's work is *forgiven* (renormalized partial answer), never
    # DROPPED (which fails the whole request).
    demoted: set = field(default_factory=set, repr=False, compare=False)
    # (nbytes, rows) charged against the global AdmissionBudget; credited
    # back by the system exactly once when the request completes.
    budget_charge: Optional[tuple] = field(default=None, repr=False,
                                           compare=False)

    def num_segments(self) -> int:
        return num_segments(self.n, self.segment_size)

    def bounds(self, s: int):
        return (start(s, self.segment_size),
                end(s, self.segment_size, self.n))

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (time.perf_counter() if now is None else now) > self.deadline

    def dropped(self) -> bool:
        """True when no stage should spend further work on this request."""
        return self.cancel_event.is_set() or self.expired()

    def demoted_for(self, m: int) -> bool:
        """True when member ``m`` was demoted off this request mid-flight
        (brownout, DESIGN.md §11): its remaining segments are forgiven
        instead of computed."""
        return bool(self.demoted) and m in self.demoted


@dataclass
class Span:
    """One contiguous row-range of one segment inside one coalesced batch.

    The batcher emits a batch as ``(buffer, [Span, ...])``; the span list is
    the scatter descriptor: batch rows ``[batch_off, batch_off + n)`` hold
    segment rows ``[seg_off, seg_off + n)`` of segment ``s`` of ``req``."""
    req: Request
    s: int                       # segment id within req
    seg_off: int                 # first row within the segment (0-based)
    batch_off: int               # first row within the batch buffer
    n: int                       # row count


class SlotRef:
    """Outstanding-chunk refcount for one flushed ring slot (DESIGN.md §3).

    The slot's chunks dispatch (and may complete) independently, but the
    underlying buffer is shared — on CPU ``device_put`` may alias host
    memory, so it can recycle only after EVERY chunk's output is
    materialized.  Each chunk calls :meth:`release` exactly once; the call
    that drops the count to zero returns True and owns the recycle.

    Deliberately lock-free: every release happens on the owning worker's
    single sender thread (skipped chunks ride the same send queue), and the
    batcher's construction happens-before via that queue — a lock here
    would cost one contended acquire per chunk on the hot path."""
    __slots__ = ("slot", "buf", "pending")

    def __init__(self, slot: Optional[int], buf: np.ndarray, pending: int):
        self.slot = slot             # ring index, or None (side-pool buffer)
        self.buf = buf
        self.pending = pending

    def release(self) -> bool:
        self.pending -= 1
        return self.pending == 0


class ChunkDesc:
    """One compiled-batch chunk cut from a flushed slot — the independently
    schedulable unit of the predictor pipeline (DESIGN.md §3).

    Slot rows ``[off, off + bucket)`` (``valid`` of them real, the tail
    zero-padded) form one jitted dispatch; ``spans`` is the scatter
    descriptor restricted to this chunk (spans never cross a compiled-batch
    boundary, so the restriction is exact).  ``level`` is the chunk's
    dispatch class — the most urgent priority among the requests whose spans
    it carries — and ``t_enq`` timestamps entry into the dispatch queue (the
    per-class ``dispatch_wait`` stage timers).  A ``__slots__`` class, not a
    dataclass: tens of thousands are created per second on the hot path."""
    __slots__ = ("ref", "off", "bucket", "valid", "spans", "level", "t_enq")

    def __init__(self, ref: SlotRef, off: int, bucket: int, valid: int,
                 spans: List[Span], level: int = PRIORITY_NORMAL,
                 t_enq: float = 0.0):
        self.ref = ref               # shared slot refcount
        self.off = off               # first slot row of this chunk
        self.bucket = bucket         # compiled (padded) batch shape
        self.valid = valid           # valid rows (<= bucket)
        self.spans = spans           # scatter descriptor, this chunk only
        self.level = level           # dispatch class
        self.t_enq = t_enq           # dispatch-queue entry (perf_counter)
