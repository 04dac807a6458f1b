"""Auto-tuning the dispatch-ahead window K in-sim (ROADMAP item l).

K trades throughput against preemptibility: each predictor pop commits up
to K chunks as one non-preemptible group, amortizing the per-group
dispatch overhead (throughput ∝ K·s/(h + K·s) under saturation) while a
high-priority chunk arriving mid-group waits out up to K−1 queued bulk
services.  The sweet spot depends on the workload's priority mix and the
overhead-to-service ratio — exactly what a trace + fitted
:class:`ServiceModel` capture, so the sweep runs in the simulator in
milliseconds instead of perturbing a live system.

Two objectives:

* ``"throughput"`` — the smallest K within ``tol`` of the best sustained
  throughput (smaller K = shorter committed window, so ties break toward
  preemptibility).  On a saturated bulk trace this reproduces the live
  default ``DISPATCH_AHEAD`` (gated in `sim.ktuner`).
* ``"latency"`` — among Ks within ``thr_slack`` of the best throughput,
  the one minimizing high-priority p99 (falling back to pooled p99 on a
  single-class trace).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

from repro_torch.serving.trace import TraceEvent

__all__ = ["tune_dispatch_ahead"]


def tune_dispatch_ahead(make_sim: Callable[[int], "SimSystem"],
                        trace: Sequence[TraceEvent], *,
                        ks: Sequence[int] = (1, 2, 4, 8, 16, 32),
                        objective: str = "throughput",
                        tol: float = 0.01,
                        thr_slack: float = 0.10) -> Dict:
    """Sweep ``ks``, running ``make_sim(k).run(trace)`` for each, and pick a
    recommendation per ``objective``.  ``make_sim`` must build a fresh
    system per call (sim state is single-use)."""
    per_k: Dict[int, dict] = {}
    for k in sorted(set(int(k) for k in ks)):
        sim = make_sim(k)
        sim.run(trace)
        r = sim.results()
        per_k[k] = {
            "throughput_rows_per_s": r["throughput_rows_per_s"],
            "p99_ms": r["p99_ms"],
            "hp_p99_ms": r.get("hp_p99_ms", r["p99_ms"]),
            "completed": r["completed"],
            "failed": r["failed"],
        }
    best_thr = max(v["throughput_rows_per_s"] for v in per_k.values())
    if objective == "throughput":
        rec = min(k for k, v in per_k.items()
                  if v["throughput_rows_per_s"] >= (1.0 - tol) * best_thr)
    elif objective == "latency":
        eligible = [k for k, v in per_k.items()
                    if v["throughput_rows_per_s"]
                    >= (1.0 - thr_slack) * best_thr]
        rec = min(eligible, key=lambda k: (per_k[k]["hp_p99_ms"], k))
    else:
        raise ValueError(f"unknown objective {objective!r}")
    return {"recommended": rec, "objective": objective,
            "best_throughput_rows_per_s": best_thr, "per_k": per_k}
