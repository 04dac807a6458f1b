"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch versions
(``ref.py``) and the public entries that dispatch between them by the
tensor's device (``ops.py``)."""
from __future__ import annotations

import threading
from typing import Dict


class Counter:
    """Thread-safe call counts by name.  Kernel wrappers add one per launch,
    the plain versions one per call, so a run can show which path it took."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {n: 0 for n in names}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            for n in self._counts:
                self._counts[n] = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)
