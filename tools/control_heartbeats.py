#!/usr/bin/env python3
"""How close the served workers come to the supervisor's watchdog.

    python3 tools/control_heartbeats.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there and runs ``chip_smoke.py``'s ``phase_control`` once
(``control:qwen3``, then ``brownout:qwen3``) while a thread samples every
routed worker's stage heartbeats each 5 ms.  Prints one JSON line: whether
the phase passed, each ``ReconfigController.apply`` (start s, seconds) and
the ten longest ACTIVE stretches seen, ``[seconds, [worker, stage], start
s]``, to hold against the 5 s watchdog (times from the script's start).
The drained instance is left out: it is out of routing.  Systems and
workers are held weakly, as the phase's drain check needs the drained
instance freed.  Run it on an older checkout unpacked beside this one and
on this one, in turns (older, this, this, older).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ACTIVE = 1          # the worker module's ACTIVE heartbeat state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is served")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control_heartbeats.py: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch.kernels import _build
    from repro_torch.serving import system as sysmod
    from repro_torch.serving.control import controller

    t_start = time.perf_counter()
    current, applies, longest = [None], [], {}
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            system = current[0]() if current[0] is not None else None
            now = time.perf_counter()
            if system is not None and not system._shutdown:
                for w in list(system.workers):
                    for stage, (state, t) in list(w._hb.items()):
                        key = (w.worker_id, stage)
                        if state == ACTIVE and \
                                now - t > longest.get(key, (0.0, 0.0))[0]:
                            longest[key] = (now - t, t - t_start)
            system = None
            time.sleep(0.005)

    build = sysmod.InferenceSystem.__init__

    def init(self, *a, **k):
        build(self, *a, **k)
        current[0] = weakref.ref(self)

    apply = controller.ReconfigController.apply

    def timed_apply(self, *a, **k):
        t = time.perf_counter()
        try:
            return apply(self, *a, **k)
        finally:
            applies.append([t - t_start, time.perf_counter() - t])

    sysmod.InferenceSystem.__init__ = init
    controller.ReconfigController.apply = timed_apply
    threading.Thread(target=sample, daemon=True).start()
    smi = chip_smoke.smi_line()
    library = _build.library()._name
    try:
        chip_smoke.phase_control(torch, 0, smi)
        ok = True
    except SystemExit:
        ok = False
    stop.set()
    top = sorted(((v[0], k, v[1]) for k, v in longest.items()),
                 reverse=True)[:10]
    print(json.dumps({"label": args.label, "src": args.src, "card": smi,
                      "library": library, "ok": ok, "apply": applies,
                      "longest_active": [[s, list(k), at]
                                         for s, k, at in top]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the phase's quarantined instance keeps its stage threads by design;
    # leave without tearing the interpreter down around them
    os._exit(code)
