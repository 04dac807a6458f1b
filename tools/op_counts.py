#!/usr/bin/env python3
"""The aten ops that one decode step, one training step and one long
forward dispatch, by op, in one checkout, on the CPU at the reduced
configs.

    python3 tools/op_counts.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), and for
qwen3, hymba, mamba2 and granite (reduced, params from seed 0; granite
with its dense and its capacity MoE) counts the
ops of ``decode_step`` after an 8-token prefill at batch 2, and of
``loss_and_grads`` with remat on a (2, 16) batch, and of ``forward`` on
one sequence of ``LONG`` tokens.  Prints one JSON line:
per config and step, the total and the count of each op.  Two checkouts
that print the same counts dispatch the same device work on those paths;
the host cost of the Python around the ops is not counted.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# granite's full config takes the capacity MoE; its reduced one the dense
# the forward's length: past the attention's dense limit (2048), so the
# chunked online-softmax loop runs
LONG = 2304
ARCHS = ("qwen3-1.7b", "hymba-1.5b", "mamba2-1.3b", "granite-moe-3b-a800m",
         "granite-moe-3b-a800m:capacity")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.training.train_loop import loss_and_grads

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    out = {"label": args.label, "src": args.src}
    for arch in ARCHS:
        name, _, impl = arch.partition(":")
        cfg = get_config(name).reduced()
        if impl:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl=impl))
        params = init_params(cfg, 0, "cpu")
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
        _, cache = prefill(params, cfg, toks[:, :8], 32)
        with Count() as dec:
            decode_step(params, cfg, cache, toks[:, 8:9], 8)
        with Count() as tr:
            loss_and_grads(params, cfg, {"tokens": toks[:, :16],
                                         "labels": toks[:, 1:]}, remat=True)
        long = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, LONG)))
        with Count() as fw:
            forward(params, cfg, long)
        out[arch] = {
            step: {"total": sum(c.ops.values()), "ops": dict(sorted(
                c.ops.items()))}
            for step, c in (("decode", dec), ("train", tr),
                            ("forward", fw))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
