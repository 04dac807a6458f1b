#!/usr/bin/env python3
"""Pair phases of ``chip_smoke.py`` from one checkout, each on a fresh
system: the first burst's rows/s, for A/Bs across checkouts.

    python3 tools/pair_runs.py [--src DIR] [--label NAME] [--profile]
                               [--pairs qwen3-1.7b,mamba2-1.3b]

Loads ``DIR/chip_smoke.py`` (default: this checkout's) and runs its
``phase_pair`` for each named pair (default: qwen3-1.7b), printing one line
of its rows/s, p50 and ``h2d_staged`` a pair and, with ``--profile``, the
``profile:`` phase's busy share and host-to-device copies by stream.  Run
it once a process on an older checkout unpacked beside this one and on
this one, in turns (older, this, this, older), to compare them on one
card.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--pairs", default="qwen3-1.7b")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pair_runs.py: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_pairs", Path(args.src).resolve() / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    torch.zeros(1, device="cuda").sum().item()    # the CUDA context
    wanted = args.pairs.split(",")
    for name, layers, int8_layers in cs.PAIRS:
        if name not in wanted:
            continue
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cs.phase_pair(torch, name, layers, int8_layers, 0, cs.smi_line(),
                          args.profile)
        for line in buf.getvalue().strip().splitlines():
            d = json.loads(line)
            if d.get("phase", "").startswith("profile:"):
                print(json.dumps({"ab": args.label, "phase": d["phase"],
                                  "device_busy_share": d["device_busy_share"],
                                  "h2d": d["h2d"]}), flush=True)
            elif d.get("phase", "").startswith("end_to_end:"):
                print(json.dumps({"ab": args.label, "phase": d["phase"],
                                  "rows_per_s": d["rows_per_s"],
                                  "p50_ms": d["p50_ms"],
                                  "h2d_staged": d.get("h2d_staged")}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
