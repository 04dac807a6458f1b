"""Dry-run: every (architecture x input shape x mesh) step traced sharded on
the production mesh, with no devices (the JAX package's
``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all                  # 1-pod
    python -m repro_torch.launch.dryrun --all --mesh multi     # 2-pod

The process joins a ``"fake"`` process group of 256 (or 512) ranks, as rank
0, and builds the production ``DeviceMesh`` on it: collectives return at
once and move nothing, and ``steps.lower_step`` traces under
``FakeTensorMode``, so nothing is allocated either.  The group is
process-wide (as the JAX dry-run's ``XLA_FLAGS`` are), so run this module
in a process of its own.  One JSON per combo is written under
``experiments/dryrun_torch/``: FLOPs, bytes accessed, collective bytes by
type, the op histogram, and ``memory_analysis`` under the JAX record's field
names, all per rank: ``argument_size_in_bytes`` and
``output_size_in_bytes`` (this rank's shards), ``temp_size_in_bytes`` (the
peak of the live bytes of the storages one step allocates, its outputs left
out, as XLA's temp: so ``argument + output - alias + temp`` bounds the
rank's peak, and for a train step ``argument + temp`` is it) and
``alias_size_in_bytes`` (outputs in an argument's storage: the in-place
AdamW update).
``generated_code_size_in_bytes`` is left out: eager PyTorch runs no
compiled program.  Every figure is PyTorch's count of the ops one rank runs
(``launch/hlo_analysis.py``), not XLA's: the peak is the eager sequence's,
not XLA's buffer assignment: its temp sits beside the JAX dry-run's as
another schedule's of the same step, not equal to it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import (ARCHITECTURES, INPUT_SHAPES, get_config,
                                 long_context_ok)
from repro_torch.launch import hlo_analysis

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def applicable(arch: str, shape: str) -> bool:
    cfg = get_config(arch)
    if shape == "long_500k" and not long_context_ok(cfg):
        return False        # pure full-attention archs skip 500k decode
    return True


def fake_process_group(world_size: int) -> None:
    """Join a ``"fake"`` group of ``world_size`` ranks as rank 0 (once per
    process; a group already up must have that size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the dry-run needs "
                               f"{world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_one(arch: str, shape: str, mesh_kind: str = "single", *,
            save: bool = True, verbose: bool = True,
            variant: str = "baseline", out_dir: str = OUT_DIR) -> dict:
    from repro_torch import runtime_flags
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
    t0 = time.perf_counter()
    multi = mesh_kind == "multi"
    sizes, names = PRODUCTION_SHAPES[multi]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": dict(zip(names, sizes)), "variant": variant,
           "ok": False}
    try:
        n = 1
        for s in sizes:
            n *= s
        fake_process_group(n)
        mesh = make_production_mesh(multi_pod=multi)
        runtime_flags.set_variant(variant, mesh)
        traced = steps_mod.lower_step(get_config(arch), shape, mesh)
        trace = traced.trace
        rec["kind"] = traced.kind
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
        rec["flops_per_rank"] = float(hlo_analysis.flops(trace))
        rec["bytes_accessed_per_rank"] = float(
            hlo_analysis.bytes_accessed(trace))
        rec["global_cost"] = {"flops": rec["flops_per_rank"] * n}
        rec["memory_analysis"] = traced.memory_analysis()
        rec["collectives"] = hlo_analysis.collective_bytes(trace)
        rec["op_histogram"] = hlo_analysis.op_histogram(trace)
        rec["ops"] = len(trace)
        rec["ok"] = True
        if verbose:
            print(f"[OK] {arch} x {shape} x {mesh_kind} "
                  f"(trace {rec['trace_s']}s, "
                  f"flops={rec['global_cost']['flops']:.3e}, "
                  f"coll={rec['collectives']['total_bytes']:.3e}B/rank)",
                  flush=True)
    except Exception as e:   # a failure here is a sharding/system bug
        rec["error"] = f"{type(e).__name__}: {e}"[-2000:]
        rec["traceback"] = traceback.format_exc()[-3000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape} x {mesh_kind}: "
                  f"{rec['error'][-500:]}", flush=True)
    finally:
        runtime_flags.set_variant("baseline")
    if save:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape}_{mesh_kind}" + \
            (f"_{variant}" if variant != "baseline" else "")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    from repro_torch import runtime_flags
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHITECTURES))
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(runtime_flags.VARIANTS))
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory of the JSON records")
    args = ap.parse_args(argv)

    combos = []
    archs = sorted(ARCHITECTURES) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            if applicable(a, s):
                combos.append((a, s))
            else:
                print(f"[SKIP] {a} x {s} (full-attention arch)")

    failures = 0
    for a, s in combos:
        rec = run_one(a, s, args.mesh, variant=args.variant,
                      out_dir=args.out)
        failures += 0 if rec["ok"] else 1
    print(f"\n{len(combos)} combos, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
