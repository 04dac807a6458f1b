#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s brownout drill on one system and count misses.

    python3 tools/brownout_drill.py [--src DIR] [--label NAME] [--drills N]
                                    [--stall S[,S...]] [--tiers T[,T...]]
                                    [--seed N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and the
drill from this checkout's ``chip_smoke.py``, builds the kernels there,
makes ``control:qwen3``'s pair on the host (qwen3-1.7b at full width in
fp32, its 14-layer cut in int8) and ``brownout:qwen3``'s system once
(one cell, ``combine="weighted"``, member 0 slowed by a repeating
``slow`` fault), takes the plain reference on the system's own workers,
and runs the drill N times (``brownout_drill``, traced: a fresh
``BrownoutController`` demoting a burst in flight).  ``--stall`` gives
member 0's stall a chunk in seconds, and ``--tiers`` the tier table:
``cost`` (the default) prices it from a fresh ``LiveBench`` warmed by a
burst, with a burst in flight beside an HTTP request refused with 429;
``0`` or ``1`` keeps that member alone.  A list is taken in turns, one
value a drill.

Each drill prints one JSON line: whether it passed (``ok``: every request
kept a tier of the controller, the cost-priced tier keeps the member of
least cost per weight, and every row is held to the combine of the
members that served it, as ``brownout:qwen3`` holds them), each request
(tier-planned at admission or demoted mid-flight, its quality, members,
forgiven rows and the stage that forgave them), the counters
``requests_demoted``, ``rows_demoted`` and ``h2d_staged`` of the drill,
the controller's tiers and the member costs, and on a miss the demotion
report (per row: the true max |Y - Y_ref|, the fit a·P1 + b·P0, the
nearest reference rows, the error against the int8 member's logits
before the output quantization, the stage that forgave it).  The last
line sums the misses.

An A/B on one card, in one call: unpack the older tree beside this one
(``git archive <commit> | tar -x -C .chip_parent``) and run

    python3 tools/brownout_drill.py --src .chip_parent --label parent
    python3 tools/brownout_drill.py --label change
    python3 tools/brownout_drill.py --label change
    python3 tools/brownout_drill.py --src .chip_parent --label parent

(parent, change, change, parent).  Needs a CUDA card; 15-21 s a drill
after about a minute of set-up on an H100.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is served")
    ap.add_argument("--label", default="")
    ap.add_argument("--drills", type=int, default=20)
    ap.add_argument("--stall", default="",
                    help="member 0's stall a chunk, s (a comma list is "
                         "taken in turns); default chip_smoke's")
    ap.add_argument("--tiers", default="cost",
                    help="cost, 0 or 1 (a comma list is taken in turns)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("brownout_drill.py: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stalls = [float(s) for s in args.stall.split(",") if s] or \
        [cs.SLOW_CHUNK_S]
    tiers = [None if t == "cost" else ((0, 1), (int(t),))
             for t in args.tiers.split(",")]
    t0 = time.perf_counter()
    _build.library()
    smi = cs.smi_line()
    cfgs, params, X = cs.control_inputs(args.seed)
    system, spec, _, httpd, batcher, url = cs.brownout_system(
        torch, cfgs, params, X, stalls[0])
    misses = 0
    try:
        weights = [float(x) for x in system.accumulator.weights]
        workers = [system.instances(0)[0], system.instances(1)[0]]
        ref, raw1 = cs.control_reference(torch, cfgs, workers, X, weights)
        del workers
        gc.collect()
        cs.emit({"brownout_drill": args.label, "src": args.src,
                 "card": smi, "setup_s": time.perf_counter() - t0})
        for d in range(args.drills):
            spec.stall_s = stalls[d % len(stalls)]
            tier = tiers[d % len(tiers)]
            t = time.perf_counter()
            run = cs.brownout_drill(torch, system, cfgs, X, url, tiers=tier,
                                    refuse=tier is None, trace=True)
            verdict = cs.drill_verdict(run, ref, raw1)
            misses += not verdict["ok"]
            cs.emit({"brownout_drill": args.label, "drill": d,
                     "stall_s": spec.stall_s, **cs.drill_line(run, verdict),
                     "drill_s": time.perf_counter() - t})
    finally:
        httpd.shutdown()
        batcher.stop()
        system.shutdown()
    cs.emit({"brownout_drill": args.label, "card": smi,
             "drills": args.drills, "stalls": stalls, "tiers": args.tiers,
             "misses": misses, "total_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
