#!/usr/bin/env python3
"""The qwen3 pair of ``chip_smoke.py`` served again and again by one warm
system, the predictor's H2D staging in three forms in turns: on each
worker's copy stream (as the port ships it), on the compute stream (the
copy stream taken away), and none (every chunk uploaded just before its
forward).

    python3 tools/staging_forms.py [--rounds 5]

Prints one line of rows/s and staged uploads a burst, then each form's
sorted rows/s.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORMS = ("copy_stream", "compute_stream", "none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("staging_forms.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSystem
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    print(cs.smi_line(), flush=True)
    cfg0 = get_config("qwen3-1.7b")
    cfg1 = cs.cut(cfg0, 14)
    params = [init_params(cfg0, 0, dev), init_params(cfg1, 1, dev)]
    alloc = AllocationMatrix(cuda_devices()[:1], [cfg0.name, cfg1.name],
                             np.array([[16, 8]]))
    system = InferenceSystem([cfg0, cfg1], params, alloc, combine="pallas",
                             use_kernel=True, max_seq=256, segment_size=32,
                             member_dtypes=["fp32", "int8"])
    X = np.random.default_rng(0).integers(0, cfg0.vocab_size, (160, 256)
                                          ).astype(np.int32)
    copies = {w.worker_id: w._copy for w in system.workers}

    def set_form(form):
        for w in system.workers:
            w._copy = None if form == "compute_stream" else \
                copies[w.worker_id]
            if form == "none":     # a staged tuple that matches no chunk
                w._stage = lambda c: (None, None, None)
            else:
                w.__dict__.pop("_stage", None)

    res = {}
    try:
        cs.serve(system, X, 4, 40)                     # warm
        for rnd in range(args.rounds):
            for form in (FORMS if rnd % 2 == 0 else FORMS[::-1]):
                set_form(form)
                before = system.serving_counters().get("h2d_staged", 0)
                torch.cuda.synchronize()
                _, wall, _ = cs.serve(system, X, 4, 40)
                staged = system.serving_counters().get("h2d_staged", 0) \
                    - before
                res.setdefault(form, []).append(160 / wall)
                print(json.dumps({"form": form, "rows_per_s": 160 / wall,
                                  "staged": staged}), flush=True)
    finally:
        system.shutdown()
    print(json.dumps({k: sorted(v) for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
