"""The online reconfiguration controller (DESIGN.md §8).

A background thread with two cadences:

* a **fast loop** (``steal_interval_s``, default 2 ms) runs the
  work-stealing balancer over every member with >= 2 data-parallel
  instances;
* a **slow loop** (``interval_s``, default 2 s) re-runs the paper's
  Algorithm 2 (bounded greedy) from the *current live allocation* against
  the :class:`~repro_torch.serving.control.livebench.LiveBench` profile, and
  applies the winning matrix's delta as live actions.

Delta application is ordered so the ensemble stays fully served and no
in-flight request is dropped: **spawns** first (capacity only goes up),
then **rebatches** (spawn the new-batch instance, then drain the old one —
a generation-tagged replacement; both serve during the handover), then
**drains** (the retiring worker leaves routing atomically, its queued
descriptors migrate to siblings, and the SHUTDOWN sentinel lets work
already accepted finish).  A failed spawn rejects that one action — the
probe worker posts no OOM sentinel, so in-flight requests never pay for a
speculative reconfiguration.

Every action appends to a bounded event log exported via ``stats()`` (the
HTTP server's ``/metrics`` and ``EnsembleClient.metrics()`` surface it).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.allocation import DEFAULT_BATCH_SIZES, AllocationMatrix
from repro_torch.core.greedy import bounded_greedy
from repro_torch.serving.control import stealing
from repro_torch.serving.control.livebench import LiveBench


class ReconfigController:
    def __init__(self, system, *, live: Optional[LiveBench] = None,
                 interval_s: float = 2.0, steal_interval_s: float = 0.002,
                 steal_threshold: int = 4, steal_max: int = 32,
                 min_gain: float = 1.15, min_observations: int = 32,
                 batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
                 max_iter: int = 3, max_neighs: int = 24,
                 replan: bool = True, steal: bool = True, seed: int = 0,
                 spawn_backoff_s: float = 0.5,
                 spawn_backoff_cap_s: float = 30.0):
        self.system = system
        self.live = live or LiveBench(system.cfgs, seq=system.max_seq)
        self.interval_s = interval_s
        self.steal_interval_s = steal_interval_s
        self.steal_threshold = steal_threshold
        self.steal_max = steal_max
        self.min_gain = min_gain
        self.min_observations = min_observations
        self.batch_sizes = tuple(batch_sizes)
        self.max_iter = max_iter
        self.max_neighs = max_neighs
        self.replan_enabled = replan
        self.steal_enabled = steal
        self.seed = seed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self.counters = {k: 0 for k in
                         ("replans", "applied", "spawns", "drains",
                          "rebatches", "steals", "stolen",
                          "spawn_failures", "respawns")}
        self.events: "deque[dict]" = deque(maxlen=64)
        # per-(device, member) spawn backoff: a failed spawn (device can't
        # host it) is skipped silently until its deadline instead of being
        # re-proposed — and re-failing — every replan tick (DESIGN.md §10)
        self.spawn_backoff_s = spawn_backoff_s
        self.spawn_backoff_cap_s = spawn_backoff_cap_s
        self._backoff: dict = {}          # (d, m) -> [fails, retry_at]
        # members whose last instance was quarantined: (d, batch) to respawn
        # in the background (Supervisor -> note_member_down)
        self._respawns: dict = {}         # m -> (d, batch)
        system.set_profiler(self.live)    # workers + broadcaster feed it
        system.controller = self

    # ---- lifecycle -----------------------------------------------------------
    def start(self) -> "ReconfigController":
        self._stop.clear()                # stop()/start() cycles are legal
        self._thread = threading.Thread(target=self._run, name="reconfig",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _run(self) -> None:
        # replan-only mode has no reason to spin at the stealer's cadence
        tick = self.steal_interval_s if self.steal_enabled \
            else self.interval_s
        next_replan = time.perf_counter() + self.interval_s
        while not self._stop.wait(tick):
            try:
                if self._respawns:        # member down: recovery first
                    self.respawn_once()
                if self.steal_enabled:
                    self.steal_once()
                if self.replan_enabled and \
                        time.perf_counter() >= next_replan:
                    self.replan_once()
                    next_replan = time.perf_counter() + self.interval_s
            except Exception as e:        # the control plane must outlive
                self._event("error", f"{type(e).__name__}: {e}")

    # ---- the fast path: work stealing ----------------------------------------
    def steal_once(self) -> int:
        """One balancing sweep over every member."""
        moved = 0
        for m in range(self.system.M):
            moved += stealing.balance_member(
                self.system, m, threshold=self.steal_threshold,
                max_items=self.steal_max, profile=self.live)
        if moved:
            with self._stats_lock:
                self.counters["steals"] += 1
                self.counters["stolen"] += moved
        return moved

    # ---- member respawn (fault tolerance, DESIGN.md §10) ---------------------
    def note_member_down(self, m: int, d: int, batch: int) -> None:
        """Called by the supervisor when member ``m`` lost its LAST instance
        (it was on device ``d`` at ``batch``).  Records the respawn intent;
        the controller loop retries it in the background under the spawn
        backoff until an instance lands."""
        with self._stats_lock:
            self._respawns[m] = (d, batch)
        self._event("member_down", f"m{m}: last instance (d{d} b{batch}) "
                                   f"quarantined; respawning in background")

    def respawn_once(self) -> int:
        """Attempt every pending member respawn (backoff-gated).  Returns
        the number of members brought back."""
        with self._stats_lock:
            pending = dict(self._respawns)
        back = 0
        for m, (d, b) in pending.items():
            if self.system.instances(m):  # raced a concurrent recovery
                with self._stats_lock:
                    self._respawns.pop(m, None)
                continue
            if self._spawn(d, m, b, self.system.generation):
                with self._stats_lock:
                    self._respawns.pop(m, None)
                    self.counters["respawns"] += 1
                self._event("respawned", f"member {m} back on d{d} b{b}")
                back += 1
        return back

    # ---- the slow path: live replanning --------------------------------------
    def replan_once(self) -> bool:
        """Score the live allocation, search its neighborhood against the
        live profile, and apply the delta when the projected gain clears
        ``min_gain``.  Returns whether a reconfiguration was applied."""
        if self.live.observations < self.min_observations:
            return False                  # profile too cold to trust
        with self.system._submit_lock:
            current = self.system.alloc.copy()
        with self._stats_lock:
            self.counters["replans"] += 1
        cur_score = self.live(current)
        if cur_score <= 0.0:
            return False
        proposed, _trace = bounded_greedy(
            current, self.live, max_iter=self.max_iter,
            max_neighs=self.max_neighs, batch_sizes=self.batch_sizes,
            seed=self.seed)
        if np.array_equal(proposed.A, current.A):
            return False
        prop_score = self.live(proposed)
        if prop_score < cur_score * self.min_gain:
            self._event("replan_held",
                        f"gain {prop_score / cur_score:.2f}x < "
                        f"{self.min_gain:.2f}x threshold")
            return False
        self.apply(proposed, current=current)
        return True

    def apply(self, target: AllocationMatrix, *,
              current: Optional[AllocationMatrix] = None) -> None:
        """Apply ``current -> target`` as live actions under a new
        generation.  Actions are individually atomic; a failed spawn rejects
        its action (and the paired drain) without touching the rest."""
        sys_ = self.system
        if current is None:
            with sys_._submit_lock:
                current = sys_.alloc.copy()
        sys_.generation += 1
        gen = sys_.generation
        spawns, rebatches, drains = [], [], []
        D, M = current.A.shape
        for d in range(D):
            for m in range(M):
                old, new = int(current.A[d, m]), int(target.A[d, m])
                if old == new:
                    continue
                if old == 0:
                    spawns.append((d, m, new))
                elif new == 0:
                    drains.append((d, m))
                else:
                    rebatches.append((d, m, new))
        done = {"spawn": 0, "rebatch": 0, "drain": 0}
        for d, m, b in spawns:
            if self._spawn(d, m, b, gen):
                done["spawn"] += 1
        for d, m, b in rebatches:
            old_w = self._find(d, m, before_gen=gen)
            if old_w is None or not self._spawn(d, m, b, gen):
                continue
            self._drain(old_w)            # replacement landed; retire old
            done["rebatch"] += 1
        for d, m in drains:
            w = self._find(d, m, before_gen=gen)
            if w is not None and self._drain(w):
                done["drain"] += 1
        with self._stats_lock:
            self.counters["spawns"] += done["spawn"]
            self.counters["rebatches"] += done["rebatch"]
            self.counters["drains"] += done["drain"]
            if any(done.values()):        # counters/events report what
                self.counters["applied"] += 1      # actually happened
        if any(done.values()):
            self._event("applied", f"generation {gen}: "
                        f"{done['spawn']} spawn / {done['rebatch']} rebatch "
                        f"/ {done['drain']} drain -> "
                        f"A={sys_.alloc.A.tolist()}")
        else:
            self._event("apply_noop",
                        f"generation {gen}: every action failed "
                        f"({len(spawns)} spawn / {len(rebatches)} rebatch / "
                        f"{len(drains)} drain attempted)")

    # ---- action helpers ------------------------------------------------------
    def _find(self, d: int, m: int, *, before_gen: int):
        for w in self.system.instances(m):
            if w.device_idx == d and w.generation < before_gen:
                return w
        return None

    def _spawn(self, d: int, m: int, b: int, gen: int) -> bool:
        key = (d, m)
        now = time.perf_counter()
        state = self._backoff.get(key)
        if state is not None and now < state[1]:
            return False                  # still backing off; skip silently
        try:
            self.system.spawn_instance(d, m, b, generation=gen)
            self._backoff.pop(key, None)  # success clears the backoff
            return True
        except Exception as e:            # reject ONE action, keep serving
            fails = (state[0] if state else 0) + 1
            delay = min(self.spawn_backoff_cap_s,
                        self.spawn_backoff_s * 2 ** (fails - 1))
            self._backoff[key] = [fails, now + delay]
            with self._stats_lock:
                self.counters["spawn_failures"] += 1
            self._event("spawn_failed",
                        f"d{d} m{m} b{b}: {e} (attempt {fails}, "
                        f"next retry in {delay:.1f}s)")
            return False

    def _drain(self, w) -> bool:
        try:
            self.system.drain_instance(w, wait=False)
            return True
        except ValueError as e:           # sole instance: keep it
            self._event("drain_skipped", str(e))
            return False

    def _event(self, kind: str, detail: str) -> None:
        with self._stats_lock:
            self.events.append({"t": time.time(), "kind": kind,
                                "detail": detail})

    # ---- observability -------------------------------------------------------
    def stats(self) -> dict:
        """Controller counters + live-profile snapshot for ``/metrics``."""
        with self._stats_lock:
            counters = dict(self.counters)
            events = list(self.events)[-8:]
        with self.system._submit_lock:
            workers = [{"id": w.worker_id, "device": w.device_idx,
                        "model": w.model_idx, "batch": w.batch_size,
                        "generation": w.generation,
                        "queue_depth": w.input_queue.qsize()}
                       for w in self.system.workers]
        return {"generation": self.system.generation,
                "enabled": {"replan": self.replan_enabled,
                            "steal": self.steal_enabled},
                "counters": counters,
                "workers": workers,
                "live": self.live.snapshot(),
                "events": events}
