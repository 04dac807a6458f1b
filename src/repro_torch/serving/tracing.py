"""End-to-end request tracing (DESIGN.md §13).

A lock-light span layer recording per-request causal timelines at chunk
granularity: admission → batcher slot-pack → dispatch-queue wait → predict
→ forward on the device → transfer → combine/post/accumulate.  Every
pipeline stage emits flat event
fields into a bounded per-track :class:`FlightRecorder` ring (drop-oldest
``deque`` — the emit is one GIL-atomic C call, so the hot path takes no
lock, retains no GC-tracked object, and pays one attribute check when
tracing is disabled).  Rings are created lazily under a small lock the
first time a track emits.

Events reuse timestamps the pipeline already computes (``chunk.t_enq``,
``Request.t_submit``, the ``StageTimers.timed`` return value), and the
per-chunk dispatch-wait record is stored grouped per dispatch round
("G" below), so tracing adds one C-level append, not allocation or
clock calls, per chunk.  The exception is the device timing of each
traced forward (two timing events, two host readings and one record per
chunk, ``Worker._record_forward``).  The port's cost of tracing is read
from its benchmark's traced runs (``servebench/run.py --trace 1``), whose
rate a change compares with its parent's (PERF.md).

The clock is pluggable: the live system uses ``time.perf_counter``; the
discrete-event simulator passes ``lambda: loop.now`` so a recorded trace
replayed live and in-sim produces directly comparable timelines (both
exports rebase to their first event).

:meth:`Tracer.export` renders the Chrome-trace / Perfetto JSON event
format (``traceEvents`` with ``ph "X"`` complete spans, ``ph "i"``
instants and ``ph "M"`` track-name metadata; ``ts``/``dur`` in
microseconds) — load it at https://ui.perfetto.dev or chrome://tracing.

:meth:`Tracer.anomaly` snapshots the flight recorder into a bounded dump
list tagged with its trigger (watchdog stall, deadline-miss burst,
brownout level change, RetriesExhausted), so the window of spans *leading
up to* a fault survives even after the ring wraps.
"""
from __future__ import annotations

import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["FlightRecorder", "Tracer", "pack_times"]

# Emitted events are 8 flat fields: (ph, name, t0_s, dur_s, rid, a, b, c)
#   ph    "X" complete span | "i" instant | "G"/"g" grouped records
#   rid   int, tuple of ints (multi-request chunks), or None
#   a,b,c positional args: scalars keyed by _SLOT_KEYS[name] at decode
#         time, or a dict in slot ``a`` (cold paths), or packed bytes in
#         slot ``a`` for "G"/"g"
#
# Storage is FLAT — the ring deque holds the 8 fields themselves, not an
# event tuple.  This is the core of the near-zero-overhead story: a
# retained tuple per event is tracked by the cyclic GC from birth, and a
# busy tracer allocates enough of them to multiply young-generation
# collections and trigger periodic FULL-heap scans (tens of ms each next
# to a JAX runtime — measured, that alone blew the 5% overhead budget).
# Flat fields are floats/strs/ints/bytes the GC never counts or scans,
# and the transient 8-tuple passed to ``deque.extend`` nets zero on the
# collector's allocation counters.
#
# "G" is the compact form for the highest-volume record (per-chunk
# dispatch_wait): the predictor stores ONE rid-free event per pop round —
# the dur slot holds the ABSOLUTE pop time, slot ``a`` the per-chunk
# enqueue times packed with :func:`pack_times`, and slots ``b``/``c``
# the attached round predict duration / committed-chunk count.  "g" is
# the single-span variant (sender transfer): a normal (t0, dur) span
# whose slot ``a`` carries the group's enqueue times purely for request
# attribution.  A device ``forward`` span (track ``<worker>/device``) is
# a "g" record whose slot ``a`` packs its one chunk's ``t_enq`` and whose
# slot ``c`` packs its host marks: the forward's enqueue start and the
# return of the sender's sync.
#
# Neither grouped form extracts request ids on the hot path.  Request
# attribution is recovered at export time by JOINING each chunk's
# ``t_enq`` against the same worker's batcher "pack" instants: a flush
# stamps one shared ``t_enq`` (a perf_counter float — collision-free
# across flushes) on its chunks AND on the pack instant that records the
# flushed rid set, and chunks never migrate between dispatch queues
# (steal/replay re-route one stage earlier and re-flush), so
# ``(worker, t_enq) -> rids`` is exact.  A pack instant that fell off a
# wrapped ring resolves to no rid — bounded-recorder semantics.
#
# Decoded form (what ``Tracer.tracks`` returns): (ph, name, t0, dur,
# rid, args) with args a dict or None; "G"/"g" args carry the unpacked
# ``t_enq`` tuple.
_Event = Tuple[str, str, float, float, Any, Any]

_PH = ("X", "i", "G", "g")
_STRIDE = 8

# positional-arg key names by event name (hot emitters pass scalars in
# slots a/b/c instead of allocating a dict per event)
_SLOT_KEYS = {
    "pack": ("chunks", "level"),
    "predict": ("chunks",),
    "transfer": ("chunks",),
    "dropped": ("s",),
    "forgive_demoted": ("s",),
    "combine": ("s", "m", "posted"),
    "post": ("s", "count"),
    "accumulate": ("s", "rows"),
}


# struct.Struct cache keyed by element count: skips the per-call format
# string build + parse (the emitter sees a handful of distinct group sizes)
_STRUCTS: Dict[int, struct.Struct] = {}


def _struct_for(n: int) -> struct.Struct:
    s = _STRUCTS.get(n)
    if s is None:
        s = _STRUCTS[n] = struct.Struct(f"<{n}d")
    return s


def pack_times(ts) -> bytes:
    """Encode a timestamp sequence as bytes for the "G" record's
    enqueue-times slot (bytes are invisible to the cyclic GC)."""
    return _struct_for(len(ts)).pack(*ts)


def _decode(ph, name, t0, dur, rid, a, b, c) -> _Event:
    """Flat ring fields -> (ph, name, t0, dur, rid, args)."""
    if ph == "G":
        args = {"t_enq": _struct_for(len(a) // 8).unpack(a)}
        if b is not None:
            args["predict_dur"] = b
        if c is not None:
            args["chunks"] = c
        return ph, name, t0, dur, rid, args
    if ph == "g":
        if isinstance(a, bytes):        # packed enqueue times inline
            args = {"t_enq": _struct_for(len(a) // 8).unpack(a), "chunks": b}
            if c is not None:           # a device span's host marks
                args["enqueued"], args["synced"] = _struct_for(2).unpack(c)
            return ph, name, t0, dur, rid, args
        return ph, name, t0, dur, rid, {"t_pop": a, "chunks": b}
    if a is None:
        return ph, name, t0, dur, rid, None
    if isinstance(a, dict):
        return ph, name, t0, dur, rid, a
    keys = _SLOT_KEYS.get(name, ("a", "b", "c"))
    return ph, name, t0, dur, rid, {
        k: v for k, v in zip(keys, (a, b, c)) if v is not None}


def _matches(erid, rid) -> bool:
    return erid == rid or (isinstance(erid, tuple) and rid in erid)


def _pack_rid_maps(tracks) -> Dict[str, Dict[float, Any]]:
    """``worker -> {flush t_enq: rid(s)}`` from the batcher pack instants
    — the attribution source grouped "G"/"g" records join against."""
    maps: Dict[str, Dict[float, Any]] = {}
    for tid, events in tracks.items():
        if not tid.endswith("/batcher"):
            continue
        m = maps.setdefault(tid[:-len("/batcher")], {})
        for _ph, name, t0, _dur, rid, _args in events:
            if name == "pack":
                m[t0] = rid
    return maps


def _round_maps(tracks) -> Dict[str, Dict[float, tuple]]:
    """``worker -> {round pop time: chunk t_enq tuple}`` from the "G"
    dispatch-round records — the second join hop for "g" records that
    carry only the round's pop-time correlation key."""
    maps: Dict[str, Dict[float, tuple]] = {}
    for tid, events in tracks.items():
        if not tid.endswith("/predict"):
            continue
        m = maps.setdefault(tid[:-len("/predict")], {})
        for ph, _name, _t0, dur, _rid, args in events:
            if ph == "G":               # dur slot = absolute pop time
                m[dur] = args["t_enq"]
    return maps


def _rid_union(m: Dict[float, Any], ts) -> Any:
    """Distinct request ids a group of chunk enqueue times resolves to."""
    rids = set()
    for t in ts:
        r = m.get(t)
        if isinstance(r, tuple):
            rids.update(r)
        elif r is not None:
            rids.add(r)
    if not rids:
        return None
    return rids.pop() if len(rids) == 1 else tuple(sorted(rids))


class FlightRecorder:
    """Bounded drop-oldest ring of trace events for one track.

    ``append`` takes one 8-field event tuple ``(ph, name, t0, dur, rid,
    a, b, c)`` and is bound directly to the underlying ``deque.extend``
    (a C builtin that never yields the GIL mid-call) — the hot path pays
    no Python frame, takes no lock, and retains no GC-tracked object:
    the argument tuple is transient and only its scalar fields survive
    in the ring.  ``snapshot`` re-chunks the flat stream, recovering
    stride alignment by locating the ph column (a copy taken while a
    full ring wraps mid-extend can start mid-event; event names are
    never 1-char ph markers, so the alignment is unambiguous).
    """

    __slots__ = ("_ring", "capacity", "append")

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=_STRIDE * self.capacity)
        self.append = self._ring.extend    # C-level, per-event hot path

    def __len__(self) -> int:
        return len(self._ring) // _STRIDE

    def snapshot(self) -> List[tuple]:
        """Aligned raw 8-field events, oldest first."""
        for _ in range(8):
            try:
                raw = list(self._ring)
            except RuntimeError:        # writer appended mid-copy: retry
                continue
            if len(raw) < _STRIDE:
                return []
            for off in range(_STRIDE):
                idx = range(off, len(raw) - _STRIDE + 1, _STRIDE)
                if all(type(raw[j]) is str and raw[j] in _PH for j in idx):
                    return [tuple(raw[j:j + _STRIDE]) for j in idx]
            # no offset validated: copy torn by a concurrent wrap, retry
        return []

    def clear(self) -> None:
        self._ring.clear()


class Tracer:
    """Per-system span recorder with per-track flight-recorder rings.

    Hot-path contract: emitters check ``tracer.enabled`` first (one
    attribute read when off) and may cache ``tracer.ring(tid)`` per
    thread, appending event tuples directly — ``span``/``instant`` are
    the convenience forms for cold paths.
    """

    def __init__(self, enabled: bool = True, capacity: int = 4096, *,
                 clock: Callable[[], float] = time.perf_counter,
                 max_dumps: int = 8, burst_n: int = 8,
                 burst_window_s: float = 1.0):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._rings: Dict[str, FlightRecorder] = {}
        self._anomalies: deque = deque(maxlen=64)
        self._dumps: deque = deque(maxlen=max_dumps)
        self._burst_window = float(burst_window_s)
        self._miss_t: deque = deque(maxlen=max(2, burst_n))
        self._last_burst = -float("inf")

    # ---- emission ------------------------------------------------------------
    def ring(self, tid: str) -> FlightRecorder:
        """Get-or-create the track's ring (locks only on first use)."""
        r = self._rings.get(tid)
        if r is None:
            with self._lock:
                r = self._rings.setdefault(tid, FlightRecorder(self.capacity))
        return r

    def span(self, tid: str, name: str, t0: float, t1: float,
             rid=None, args: Optional[dict] = None) -> None:
        if self.enabled:
            self.ring(tid).append(
                ("X", name, t0, t1 - t0, rid, args, None, None))

    def instant(self, tid: str, name: str, t: Optional[float] = None,
                rid=None, args: Optional[dict] = None) -> None:
        if self.enabled:
            if t is None:
                t = self.clock()
            self.ring(tid).append(("i", name, t, 0.0, rid, args, None, None))

    # ---- anomaly-triggered dumps --------------------------------------------
    def anomaly(self, trigger: str, detail: str = "",
                args: Optional[dict] = None) -> Optional[dict]:
        """Record an anomaly and freeze a flight-recorder snapshot tagged
        with the trigger.  Returns the dump (or None when disabled)."""
        if not self.enabled:
            return None
        t = self.clock()
        info = {"trigger": trigger, "detail": detail, "t": t}
        if args:
            info.update(args)
        self._anomalies.append(info)
        self.ring("anomalies").append(
            ("i", trigger, t, 0.0, None, {"detail": detail}, None, None))
        dump = self.export()
        dump["metadata"]["dump_trigger"] = dict(info)
        self._dumps.append(dump)
        return dump

    def note_deadline_miss(self) -> None:
        """Per-miss hook with burst detection: ``burst_n`` misses inside
        ``burst_window_s`` fire one rate-limited anomaly dump."""
        if not self.enabled:
            return
        t = self.clock()
        m = self._miss_t
        m.append(t)
        if (len(m) == m.maxlen and t - m[0] <= self._burst_window
                and t - self._last_burst > self._burst_window):
            self._last_burst = t
            self.anomaly("deadline_miss_burst",
                         f"{m.maxlen} deadline misses in {t - m[0]:.3f}s")

    def dumps(self) -> List[dict]:
        return list(self._dumps)

    def anomalies(self) -> List[dict]:
        return list(self._anomalies)

    # ---- inspection ----------------------------------------------------------
    def tracks(self) -> Dict[str, List[_Event]]:
        with self._lock:
            items = list(self._rings.items())
        return {tid: [_decode(*ev) for ev in r.snapshot()]
                for tid, r in items}

    def timeline(self, rid: int) -> List[Tuple[str, str, str, float, float]]:
        """All events touching request ``rid`` as
        ``(track, ph, name, t0, dur)`` sorted by start time — the
        connected admission→combine view of one request.  Grouped
        records resolve per-chunk attribution through the pack-instant
        join (see the storage notes at the top of this module)."""
        out = []
        tracks = self.tracks()
        maps = _pack_rid_maps(tracks)
        rounds = _round_maps(tracks)
        for tid, events in tracks.items():
            w = tid.rsplit("/", 1)[0]
            m = maps.get(w, {})
            rm = rounds.get(w, {})
            for ph, name, t0, dur, erid, args in events:
                if ph == "G":           # one span per grouped chunk
                    ts = args["t_enq"]
                    if erid is not None:    # emitter attributed eagerly
                        mine = ts if _matches(erid, rid) else ()
                    else:
                        mine = [t for t in ts if _matches(m.get(t), rid)]
                    # dur slot holds the round's absolute pop time
                    out.extend((tid, "X", name, t, dur - t) for t in mine)
                    if mine and args.get("predict_dur") is not None:
                        out.append((tid, "X", "predict", dur,
                                    args["predict_dur"]))
                    continue
                if ph == "g":
                    ts = args.get("t_enq")
                    if ts is None:
                        ts = rm.get(args.get("t_pop"), ())
                    er = erid if erid is not None else _rid_union(m, ts)
                    if _matches(er, rid):
                        out.append((tid, "X", name, t0, dur))
                    continue
                if _matches(erid, rid):
                    out.append((tid, ph, name, t0, dur))
        out.sort(key=lambda e: (e[3], e[1] != "X"))
        return out

    def clear(self) -> None:
        with self._lock:
            rings = list(self._rings.values())
        for r in rings:
            r.clear()
        self._miss_t.clear()

    # ---- Chrome-trace / Perfetto export -------------------------------------
    def export(self, *, process_name: str = "serving") -> dict:
        """Render every track as Chrome-trace JSON (ts/dur in µs, rebased
        to the earliest recorded event so live and virtual-clock runs
        line up at t=0)."""
        tracks = self.tracks()
        maps = _pack_rid_maps(tracks)
        rounds = _round_maps(tracks)
        base = min((ev[2] for events in tracks.values() for ev in events),
                   default=0.0)
        trace_events: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": process_name},
        }]

        def rid_args(rid) -> Dict[str, Any]:
            if isinstance(rid, tuple):
                return {"rids": list(rid)}
            return {} if rid is None else {"rid": rid}

        for tno, tid in enumerate(sorted(tracks), start=1):
            trace_events.append({
                "ph": "M", "name": "thread_name", "pid": 0, "tid": tno,
                "args": {"name": tid},
            })
            trace_events.append({
                "ph": "M", "name": "thread_sort_index", "pid": 0, "tid": tno,
                "args": {"sort_index": tno},
            })
            w = tid.rsplit("/", 1)[0]
            m = maps.get(w, {})
            rm = rounds.get(w, {})
            for ph, name, t0, dur, rid, args in tracks[tid]:
                if ph == "G":           # expand to one "X" span per chunk
                    ts = args["t_enq"]
                    trace_events.extend({
                        "ph": "X", "name": name, "cat": "serving",
                        "pid": 0, "tid": tno, "ts": 1e6 * (t - base),
                        "dur": 1e6 * (dur - t),
                        "args": rid_args(rid if rid is not None
                                         else m.get(t)),
                    } for t in ts)
                    if args.get("predict_dur") is not None:
                        a = rid_args(rid if rid is not None
                                     else _rid_union(m, ts))
                        a["chunks"] = args.get("chunks")
                        trace_events.append({
                            "ph": "X", "name": "predict", "cat": "serving",
                            "pid": 0, "tid": tno, "ts": 1e6 * (dur - base),
                            "dur": 1e6 * args["predict_dur"], "args": a,
                        })
                    continue
                if ph == "g":           # grouped single span
                    ts = args.get("t_enq")
                    if ts is None:
                        ts = rm.get(args.get("t_pop"), ())
                    a = rid_args(rid if rid is not None
                                 else _rid_union(m, ts))
                    a["chunks"] = args.get("chunks")
                    trace_events.append({
                        "ph": "X", "name": name, "cat": "serving",
                        "pid": 0, "tid": tno, "ts": 1e6 * (t0 - base),
                        "dur": 1e6 * dur, "args": a,
                    })
                    continue
                ev: Dict[str, Any] = {
                    "ph": ph, "name": name, "cat": "serving",
                    "pid": 0, "tid": tno,
                    "ts": 1e6 * (t0 - base),
                }
                a = dict(args) if args else {}
                a.update(rid_args(rid))
                if ph == "X":
                    ev["dur"] = 1e6 * dur
                else:
                    ev["s"] = "t"       # thread-scoped instant
                if a:
                    ev["args"] = a
                trace_events.append(ev)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "metadata": {
                "clock": ("virtual" if getattr(
                    self.clock, "__name__", "<lambda>") == "<lambda>"
                    else self.clock.__name__),
                "base_s": base,
                "anomalies": list(self._anomalies),
            },
        }
