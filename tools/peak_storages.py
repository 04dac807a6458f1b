#!/usr/bin/env python3
"""The largest storages live at the peak of one rank's dry-run step, each
with the aten op that allocated it and the ``repro_torch`` frame it came
from.

    python3 tools/peak_storages.py --arch qwen3-1.7b --shape train_4k
        [--mesh single|multi] [--variant V] [--top 12] [--src DIR]

Traces the (arch, shape) step as ``python -m repro_torch.launch.dryrun``
does (a fake process group of the production mesh's size, the step under
``FakeTensorMode``) and follows the same live-storage count as the
dry-run's ``temp_size_in_bytes`` (``launch/hlo_analysis.Memory``), but
keeps, for every storage, the op and the innermost frame of
``src/repro_torch`` (``[bwd]`` when autograd's backward allocated it).  It
replays the step's allocations and frees, the step's outputs left out as
the tree's temp leaves them out, and prints the ``--top`` largest storages
live at the peak, then one JSON line: the peak, its sum over the rows
printed and the rest.  Run it in a process of its own (the fake group is
process-wide).  Imports ``repro_torch`` from ``DIR/src`` (default: this
checkout), so an older tree can be read the same way.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _frame(pkg: str) -> str:
    """The innermost frame of the package below this call, but not of the
    dry-run's own recorder."""
    for fr in reversed(traceback.extract_stack()):
        if pkg in fr.filename and "hlo_analysis" not in fr.filename:
            return f"{fr.filename.split(pkg, 1)[1]}:{fr.lineno}"
    return "?"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--src", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import torch

    from repro_torch import runtime_flags
    from repro_torch.configs import get_config
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh

    pkg = "src/repro_torch/"
    info = {}           # allocation number -> (bytes, op, frame)
    log = []            # (allocation number, +-bytes), in order
    live_num = {}       # live storage id -> allocation number
    outputs = set()     # allocation numbers of the step's outputs
    op = ["?"]

    track = H._Recorder._track

    def tracked(self, name, a, out):
        op[0] = name
        return track(self, name, a, out)

    def freed(key, num, n):
        live_num.pop(key, None)
        log.append((num, -n))

    class Named(H.Memory):
        def alloc(self, storage):
            super().alloc(storage)
            num, n = len(info), storage.nbytes()
            bwd = torch._C._current_graph_task_id() != -1
            info[num] = (n, op[0], ("[bwd] " if bwd else "") + _frame(pkg))
            live_num[id(storage)] = num
            log.append((num, n))
            weakref.finalize(storage, freed, id(storage), num, n)

    record = H.record_with_memory

    def recorded(fn, *a, **k):
        out, trace, memory = record(fn, *a, **k)
        outputs.update(live_num[i] for i in H.storage_ids(out)
                       if i in live_num)
        return out, trace, memory

    H._Recorder._track = tracked
    H.Memory = Named
    H.record_with_memory = recorded

    multi = args.mesh == "multi"
    sizes, _ = PRODUCTION_SHAPES[multi]
    n = 1
    for s in sizes:
        n *= s
    fake_process_group(n)
    mesh = make_production_mesh(multi_pod=multi)
    runtime_flags.set_variant(args.variant, mesh)
    tr = steps.lower_step(get_config(args.arch), args.shape, mesh)
    mem = tr.memory_analysis()
    # the storages live when the dry-run's temp peaks: its outputs are left
    # out where the tree's temp leaves them out (Memory.peak_without)
    skip = outputs if hasattr(H.Memory, "peak_without") else set()
    live, total, peak, at_peak = set(), 0, 0, set()
    for num, n in log:
        if num in skip:
            continue
        total += n
        (live.add if n > 0 else live.discard)(num)
        if total > peak:
            peak, at_peak = total, set(live)
    rows = sorted((info[k] for k in at_peak), key=lambda r: -r[0])
    print(f"{args.arch} x {args.shape} x {args.mesh} ({args.variant}): "
          f"temp {mem['temp_size_in_bytes']:,} B, argument "
          f"{mem['argument_size_in_bytes']:,} B, output "
          f"{mem['output_size_in_bytes']:,} B per rank; "
          f"{len(rows)} storages live at the peak")
    print(f"{'GB':>9}  {'op':<40} frame")
    for nbytes, name, where in rows[:args.top]:
        print(f"{nbytes / 1e9:9.3f}  {name:<40} {where}")
    shown = sum(r[0] for r in rows[:args.top])
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": args.mesh, "variant": args.variant,
                      "memory_analysis": mem, "peak_live_bytes": peak,
                      "top_bytes": shown, "rest_bytes": peak - shown,
                      "storages": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
