"""The one traffic generator.  A mix is a JSON file of parameters under
``servebench/traffic/``; its ``"kind"`` names the arrival process,
``servebench/arrivals/<kind>.py``, whose ``run(system, spec, cfg, seed, t0,
seconds)`` sends the mix's requests over the window and returns them:

* ``closed``: C callers, each sends a request of R rows and the next when
  its answer comes back;
* ``open``: requests due at Poisson arrivals of a fixed rate, of sizes
  drawn from a heavy-tailed distribution, in one order the mix fixes.

Every mix takes ``"warmup_rows"``: the request sizes sent one at a time
during set-up, so that every batch shape the mix uses is warm.

The work is the same for every seed: the run's seed draws only the token
ids, uniform over the vocabulary (``tokens``).  Every request is timed
from the moment it was due (an open mix) or sent (a closed one) to the
moment its answer came back to the caller.
"""
from __future__ import annotations

import importlib.util
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

ARRIVALS = Path(__file__).resolve().parents[1] / "arrivals"
LATE_S = 60.0                # how long past the window an answer is awaited


@dataclass
class Request:
    idx: int
    rows: int
    due: float               # perf_counter the request was due
    X: np.ndarray
    sent: Optional[float] = None
    done: Optional[float] = None
    Y: Optional[np.ndarray] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.done is not None and self.error is None

    @property
    def latency_s(self) -> float:
        return self.done - self.due if self.ok else math.inf


def tokens(seed: int, stream: int, k: int, rows: int, seq: int,
           vocab: int) -> np.ndarray:
    """Request ``k`` of caller ``stream``: (rows, seq) int32 ids, uniform
    over the vocabulary."""
    rng = np.random.default_rng([seed % 2 ** 64, stream, k])
    return rng.integers(0, vocab, (rows, seq), dtype=np.int64).astype(np.int32)


def finish(req: Request, handle, deadline: float) -> None:
    """Wait for ``req``'s answer until ``deadline`` and stamp it."""
    try:
        req.Y = handle.result(max(0.1, deadline - time.perf_counter()))
        req.done = time.perf_counter()
    except Exception as e:           # an answer that never came, or an error
        req.error = f"{type(e).__name__}: {e}"


def arrival(kind: str):
    """The module ``servebench/arrivals/<kind>.py``."""
    path = ARRIVALS / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic kind {kind!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        "servebench_arrival_" + kind.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(system, spec: dict, cfg: dict, seed: int, t0: float,
        seconds: float) -> List[Request]:
    return arrival(spec["kind"]).run(system, spec, cfg, seed, t0, seconds)


def warm(system, spec: dict, cfg: dict) -> None:
    """Send each of the mix's ``warmup_rows`` sizes once and wait for it."""
    for i, rows in enumerate(spec.get("warmup_rows", [])):
        X = tokens(0, 1 << 30, i, int(rows), cfg["max_seq"],
                   cfg["vocab_size"])
        system.predict(X, timeout=600.0)
