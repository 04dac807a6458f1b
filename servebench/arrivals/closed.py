"""A closed loop: ``{"kind": "closed", "clients": C, "rows": R}``.  Each of C
callers sends a request of R rows from the window's start, and the next
when its answer comes back, until the window closes."""
from __future__ import annotations

import threading
import time
from typing import List

from harness.traffic import LATE_S, Request, finish, tokens


def run(system, spec: dict, cfg: dict, seed: int, t0: float,
        seconds: float) -> List[Request]:
    """Returns every request sent, in the order sent."""
    t_end = t0 + seconds
    out: List[List[Request]] = [[] for _ in range(spec["clients"])]

    def client(c: int):
        k = 0
        while True:
            X = tokens(seed, c + 1, k, spec["rows"], cfg["max_seq"],
                       cfg["vocab_size"])
            now = time.perf_counter()
            if now >= t_end:
                return
            req = Request(idx=c * 1_000_000 + k, rows=spec["rows"], due=now,
                          X=X, sent=now)
            out[c].append(req)
            try:
                h = system.predict_async(X)
            except Exception as e:
                req.error = f"{type(e).__name__}: {e}"
                return
            finish(req, h, t_end + LATE_S)
            if not req.ok:
                return
            k += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"servebench-client{c}")
               for c in range(spec["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sorted((r for rs in out for r in rs), key=lambda r: r.due)
