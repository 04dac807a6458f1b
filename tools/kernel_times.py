#!/usr/bin/env python3
"""Device times of the port's redesigned kernels in one checkout.

    python3 tools/kernel_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, and prints one JSON line: ``flash_attention`` at the
qwen3 and hymba serving shapes, ``ensemble_combine`` in place at qwen3's
segment, ``ssd_scan`` at the mamba2 and hymba serving shapes and
``decode_attention`` at qwen3's last decode step (1088 valid slots) and
hymba's full window ring, timed by ``chip_smoke.py``'s own ``time_flash``,
``time_combine``, ``time_ssd`` and ``time_decode`` (device ms beside
SDPA's and ``torch.add``'s, enqueued ms, host µs per call) on inputs made
from a fixed seed.  Run it on an older
checkout unpacked beside this one and on this one, in turns (older, this,
this, older), to compare two versions of a kernel on one card.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times.py: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import (DECODE_TIMED, FLASH_CASES, HYMBA_FLASH,
                            HYMBA_SSD, MAIN_FLASH, MAIN_SSD, combine_sets,
                            decode_inputs, decode_valid, flash_inputs,
                            smi_line,
                            ssd_inputs, time_combine, time_decode,
                            time_flash, time_ssd)
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ensemble_combine as ec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"label": args.label, "src": args.src, "card": smi_line(),
           "library": _build.library()._name, "flash": []}
    for shape in (MAIN_FLASH, HYMBA_FLASH):
        window = next(c[5] for c in FLASH_CASES if c[:5] == shape)
        qs, k, v = flash_inputs(torch, gen, dev, *shape, torch.float32)
        out["flash"].append({"shape": list(shape), "window": window,
                             **time_flash(torch, fa, ref, qs, k, v, window)})
    out["combine"] = time_combine(torch, ec, ref,
                                  combine_sets(torch, gen, dev))
    out["ssd"] = []
    for shape in (MAIN_SSD, HYMBA_SSD):
        x, dt, A, bm, cm = ssd_inputs(torch, gen, dev, *shape[:5])
        out["ssd"].append({"shape": list(shape),
                           **time_ssd(torch, ssd, ref, x, dt, A, bm, cm,
                                      shape[-1])})
    out["decode"] = []
    for shape, kind in DECODE_TIMED:
        qs, k, v = decode_inputs(torch, gen, dev, *shape, torch.float32)
        valid = decode_valid(torch, kind, shape[1], gen, dev)
        out["decode"].append({"shape": list(shape),
                              **time_decode(torch, da, ref, qs, k, v,
                                            valid)})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
