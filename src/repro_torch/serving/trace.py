"""Request traces: record live arrivals, replay them anywhere.

A *trace* is a list of :class:`TraceEvent` — one per offered request, sorted
by arrival offset ``t`` (seconds from trace start).  The schema is the
minimum the planner cares about: when the request arrived, how many rows it
carried, its priority class, its relative deadline, and the member subset it
asked for.  Payload contents are deliberately not recorded — the scheduler
is shape-driven, so a trace replays bit-equivalently with synthetic rows.

Producers:
  * :class:`TraceRecorder` attached to ``InferenceSystem.trace_recorder``
    (or via ``launch/serve.py --record-trace``) records live offered load.
  * ``repro_torch.serving.sim.traces`` generates synthetic Poisson / MMPP /
    diurnal traces.

Consumers:
  * ``repro_torch.serving.sim`` replays traces under a virtual clock.
  * ``benchmarks/serving_hotpath.py --replay-trace`` replays them against a
    real (fake-device) ``InferenceSystem`` with wall-clock pacing.

On disk a trace is JSONL, one event per line:

    {"t": 0.0123, "rows": 64, "priority": "high", "deadline_ms": 50.0,
     "members": [0, 2]}

``deadline_ms`` and ``members`` are ``null`` when unset (no deadline / full
ensemble).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import IO, Iterable, List, Optional, Sequence

from repro_torch.serving.segments import PRIORITY_HIGH, priority_level

__all__ = ["TraceEvent", "TraceRecorder", "save_trace", "load_trace"]


@dataclass(frozen=True)
class TraceEvent:
    """One offered request: arrival offset + admission-relevant shape."""
    t: float                               # seconds from trace start
    rows: int
    priority: str = "normal"               # "high" | "normal"
    deadline_ms: Optional[float] = None    # relative deadline, None = none
    members: Optional[Sequence[int]] = None  # None = full ensemble

    def level(self) -> int:
        return priority_level(self.priority)

    def to_json(self) -> str:
        return json.dumps({
            "t": round(float(self.t), 9), "rows": int(self.rows),
            "priority": self.priority,
            "deadline_ms": self.deadline_ms,
            "members": list(self.members) if self.members is not None else None,
        }, separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "TraceEvent":
        d = json.loads(line)
        members = d.get("members")
        return cls(t=float(d["t"]), rows=int(d["rows"]),
                   priority=str(d.get("priority", "normal")),
                   deadline_ms=(None if d.get("deadline_ms") is None
                                else float(d["deadline_ms"])),
                   members=None if members is None else tuple(members))


class TraceRecorder:
    """Thread-safe arrival recorder.

    ``record()`` is called from the broadcaster under submission load, so it
    does no I/O by default — events accumulate in memory and are written by
    ``save()`` / ``close()``.  Pass ``stream`` (or ``path``) to additionally
    append each event as it arrives (crash-safe recording for long serves).

    The clock is ``time.perf_counter`` rebased to the first recorded event,
    so traces always start near t=0.
    """

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO[str]] = None,
                 clock=time.perf_counter):
        self._lock = threading.Lock()
        self._events: List[TraceEvent] = []
        self._clock = clock
        self._t0: Optional[float] = None
        self._own_stream = False
        if path is not None and stream is None:
            stream = open(path, "w", encoding="utf-8")
            self._own_stream = True
        self._stream = stream

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def record(self, rows: int, *, priority=PRIORITY_HIGH + 1,
               deadline_ms: Optional[float] = None,
               members: Optional[Sequence[int]] = None,
               t: Optional[float] = None) -> TraceEvent:
        """Record one offered request.  ``priority`` accepts the public
        string form ("high"/"normal") or the internal int level."""
        cls = "high" if priority_level(priority) == PRIORITY_HIGH else "normal"
        with self._lock:
            if t is None:
                now = self._clock()
                if self._t0 is None:
                    self._t0 = now
                t = now - self._t0
            ev = TraceEvent(t=t, rows=int(rows), priority=cls,
                            deadline_ms=deadline_ms,
                            members=tuple(members) if members is not None
                            else None)
            self._events.append(ev)
            if self._stream is not None:
                self._stream.write(ev.to_json() + "\n")
            return ev

    def events(self) -> List[TraceEvent]:
        """Snapshot, sorted by arrival time (stable for equal t)."""
        with self._lock:
            return sorted(self._events, key=lambda e: e.t)

    def save(self, path: str) -> int:
        evs = self.events()
        save_trace(path, evs)
        return len(evs)

    def close(self) -> None:
        with self._lock:
            if self._stream is not None:
                if self._own_stream:
                    self._stream.close()
                else:
                    self._stream.flush()
                self._stream = None


def save_trace(path: str, events: Iterable[TraceEvent]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for ev in events:
            f.write(ev.to_json() + "\n")


def load_trace(path: str) -> List[TraceEvent]:
    out: List[TraceEvent] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceEvent.from_json(line))
    out.sort(key=lambda e: e.t)
    return out
