"""Worker supervision: heartbeat/liveness sweep + crash containment
(DESIGN.md §10).

The paper's failure model (§II.C.2) is all-or-nothing: any worker posting
the {-1, None, None} sentinel fails every in-flight request and shuts the
system down.  The :class:`Supervisor` replaces that with *containment*: it
periodically reads every live worker's :meth:`Worker.health` verdict —

  * **DEAD**: a stage thread crashed (``Worker.crashed`` event) or exited;
  * **DEGRADED**: a stage has been mid-work (ACTIVE heartbeat) longer than
    the watchdog — a stalled device call, a wedged lock, an injected stall;

— and quarantines any non-READY instance via
``InferenceSystem.quarantine_instance``, which atomically removes it from
routing and resubmits (or, for a sole instance, forgives) its outstanding
units.  Detection and policy live here; the routing/recovery mutation lives
with the other topology operations on the system.

Two detection paths share the same sweep:

  * the **fast path**: a dying stage thread calls ``on_worker_crash`` (the
    worker's ``on_crash`` hook) which wakes the sweep immediately — crash
    containment latency is scheduling noise, not the sweep interval;
  * the **slow path**: the interval tick catches stalls (a stalled thread
    never calls anything) and any crash whose hook failed.

Counters (ride ``serving_counters()`` / ``GET /metrics``):
``worker_crashes``, ``stalls_detected``, ``quarantines``,
``segments_replayed`` (the last two from ``quarantine_instance``).
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.serving.worker import HEALTH_DEAD, HEALTH_DEGRADED, Worker


class Supervisor:
    def __init__(self, system, *, watchdog_s: float = 5.0,
                 interval_s: float = 0.05, retry_budget: int = 2):
        self.system = system
        self.watchdog_s = watchdog_s
        self.interval_s = interval_s
        self.retry_budget = retry_budget
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="supervisor",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # ---- fast path: called on the dying stage thread -------------------------
    def on_worker_crash(self, worker: Worker, exc: BaseException) -> None:
        """The worker's ``on_crash`` hook.  Runs on the stage thread that is
        about to die, so it only counts and wakes the sweep — quarantine
        (which takes the submit lock and may fail requests) happens on the
        supervisor thread."""
        self.system.timers.inc("worker_crashes")
        self._wake.set()

    # ---- the sweep -----------------------------------------------------------
    def _run(self) -> None:
        while True:
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.sweep()
            except Exception:
                # a sweep failure must never kill supervision; the next
                # tick retries with fresh state
                self.system.timers.inc("supervisor_errors")

    def sweep(self) -> int:
        """One detection pass: quarantine every non-READY live worker.
        Returns the number quarantined (exposed for tests)."""
        system = self.system
        with system._submit_lock:
            workers = list(system.workers)
        hit = 0
        for w in workers:
            h = w.health(self.watchdog_s)
            if h == HEALTH_DEAD or h == HEALTH_DEGRADED:
                if h == HEALTH_DEGRADED:
                    system.timers.inc("stalls_detected")
                    tr = getattr(system, "tracer", None)
                    if tr is not None:
                        # freeze the flight recorder before quarantine tears
                        # the stalled worker's state down (DESIGN.md §13)
                        tr.anomaly("watchdog_stall", w.worker_id)
                system.quarantine_instance(w, retry_budget=self.retry_budget)
                hit += 1
        return hit
