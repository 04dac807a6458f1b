"""An open loop: ``{"kind": "open", "rate_rps": L, "rows_min": a,
"rows_max": b, "rows_alpha": s, "order_seed": o}``.  Requests are due at
Poisson arrivals of rate L, each of r rows with P(r) proportional to r^-s
over a..b.

The sizes and gaps are the stratified quantiles of their distributions
(each size and each gap once per 1/N of probability), in the one order
that ``order_seed`` fixes: which large requests arrive close together is
part of the mix, not of the run's seed.  (At four fifths of the knee, a
new order per seed, or the one order started at another point, moved the
tail by 13-22 % from seed to seed.)
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List

import numpy as np

from harness.traffic import LATE_S, Request, finish, tokens

WAITERS = 24                 # threads waiting on the answers


def size_quantiles(n: int, lo: int, hi: int, alpha: float) -> np.ndarray:
    """``n`` sizes, the (i + 1/2)/n quantiles of P(r) ~ r^-alpha over
    lo..hi."""
    r = np.arange(lo, hi + 1)
    cdf = np.cumsum(r ** -float(alpha))
    cdf /= cdf[-1]
    u = (np.arange(n) + 0.5) / n
    return r[np.searchsorted(cdf, u)]


def schedule(spec: dict, seconds: float):
    """(due offsets in s, sizes) over ``seconds``: N = round(rate x
    seconds) requests whose gaps are the exponential's stratified
    quantiles, scaled so that all N fall inside the window, and whose
    sizes are the size distribution's, in the mix's one order."""
    rate = float(spec["rate_rps"])
    n = max(1, round(rate * seconds))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    gaps *= (n - 0.5) / rate / gaps.sum()
    rng = np.random.default_rng(spec["order_seed"])
    gaps = rng.permutation(gaps)
    sizes = rng.permutation(size_quantiles(n, spec["rows_min"],
                                           spec["rows_max"],
                                           spec["rows_alpha"]))
    due = np.cumsum(gaps) - gaps[0]
    return due, sizes


def run(system, spec: dict, cfg: dict, seed: int, t0: float,
        seconds: float) -> List[Request]:
    """Send each request when it is due, whether or not earlier answers
    have come back (``predict_async`` may block on the system's in-flight
    window: that wait counts as latency).  Returns every request due in
    the window."""
    due, sizes = schedule(spec, seconds)
    t_end = t0 + seconds
    pending: "queue.SimpleQueue" = queue.SimpleQueue()

    def waiter():
        while True:
            item = pending.get()
            if item is None:
                return
            finish(*item, t_end + LATE_S)

    waiters = [threading.Thread(target=waiter, daemon=True,
                                name=f"servebench-waiter{i}")
               for i in range(WAITERS)]
    for t in waiters:
        t.start()
    reqs = []
    for k, (off, rows) in enumerate(zip(due, sizes)):
        X = tokens(seed, 0, k, int(rows), cfg["max_seq"], cfg["vocab_size"])
        req = Request(idx=k, rows=int(rows), due=t0 + float(off), X=X)
        reqs.append(req)
        wait = req.due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        req.sent = time.perf_counter()
        try:
            pending.put((req, system.predict_async(X)))
        except Exception as e:
            req.error = f"{type(e).__name__}: {e}"
    for _ in waiters:
        pending.put(None)
    for t in waiters:
        t.join()
    return reqs
