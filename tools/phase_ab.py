#!/usr/bin/env python3
"""Plain-path phases of ``chip_smoke.py`` in one checkout, for an A/B.

    python3 tools/phase_ab.py [--src DIR] [--label NAME] [--pod]
                              [--only CONFIG]

Loads ``DIR/chip_smoke.py`` (default: this checkout's) and runs its phases
that time the plain PyTorch paths around the kernels: the qwen3 and granite
pairs (``end_to_end:``), ``generate:`` for qwen3, hymba, mamba2 and granite,
and ``train:qwen3`` (with ``train:ckpt``); with ``--pod`` also
``train:pod`` (a checkout that has it).  ``--only`` keeps the pair and
``generate:`` phases of the one config, and skips training.  Each phase prints its own JSON
line, then ``{"ab": NAME, "phase_s": s}``.  Run it on an older checkout
unpacked beside this one and on this one, in turns (older, this, this,
older), to compare their plain paths on one card.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose chip_smoke.py and src/ are run")
    ap.add_argument("--label", default="")
    ap.add_argument("--pod", action="store_true")
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("phase_ab.py: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", Path(args.src).resolve() / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    torch.zeros(1, device="cuda").sum().item()    # the CUDA context
    smi = cs.smi_line()
    cs.emit({"ab": args.label, "src": args.src, "card": smi,
             "build_s": time.perf_counter() - t0})

    def timed(fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        cs.emit({"ab": args.label, "phase_s": time.perf_counter() - t})
        return out

    for name, layers, int8_layers in cs.PAIRS:
        if name in ((args.only,) if args.only else
                    ("qwen3-1.7b", "granite-moe-3b-a800m")):
            timed(cs.phase_pair, torch, name, layers, int8_layers, 0, smi)
    for name, layers, prompt, max_len, int8_kv in cs.GEN_PHASES:
        if not int8_kv and (name == args.only if args.only else
                            name != "llama-3.2-vision-11b"):
            timed(cs.phase_generate, torch, name, layers, prompt, max_len,
                  int8_kv, 0, smi)
    if args.only:
        return 0
    got = timed(cs.phase_train, torch, 0, smi, False)
    if args.pod:
        import torch.distributed as dist
        try:
            timed(cs.phase_pod, torch, 0, smi, got[1])
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
