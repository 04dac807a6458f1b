"""The virtual clock and event heap.

One ``heapq`` of ``(t, seq, fn, args)`` where ``seq`` is a monotone
counter: events at equal timestamps fire in schedule order, so a single
run is a pure function of (trace, seed) — no wall clock, no thread
interleavings.  This is what makes same-seed runs bit-identical
(tests/test_sim.py::test_determinism_bit_identical).
"""
from __future__ import annotations

import heapq
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["EventLoop"]

_INF = float("inf")


class EventLoop:
    __slots__ = ("now", "_heap", "_seq")

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = 0

    def schedule(self, t: float, fn: Callable, *args: Any) -> None:
        """Schedule ``fn(*args)`` at virtual time ``t`` (clamped to now)."""
        if t < self.now:
            t = self.now
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, fn, args))

    def after(self, dt: float, fn: Callable, *args: Any) -> None:
        self.schedule(self.now + dt, fn, *args)

    def peek(self) -> float:
        """Timestamp of the next pending event, +inf if none."""
        return self._heap[0][0] if self._heap else _INF

    def step(self) -> bool:
        """Fire the next event; returns False when the heap is empty."""
        if not self._heap:
            return False
        t, _, fn, args = heapq.heappop(self._heap)
        self.now = t
        fn(*args)
        return True

    def run(self, until: Optional[float] = None) -> None:
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                self.now = until
                return
            self.step()
