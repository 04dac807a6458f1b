"""Run one cell of the benchmark once and print its result line.

    python3 servebench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the program under
test is ``src/repro_torch``.  Needs a CUDA card: without one (or with
fewer than the cell asks for) it exits 2 and prints no result.  The last
line of standard output is one JSON object; the numbers compared with the
reference are the last lines of standard error and the last key of that
object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Import paths, and every build or kernel cache inside the checkout."""
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    cache = ROOT / ".servebench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from harness import cell
    spec = cell.load_spec(args.workload, ROOT)
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"servebench: {args.workload} needs {chips} CUDA card(s), "
              f"found {n}; no result", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = cell.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START, device=dev)
    bad = forbidden_modules()
    if bad:
        print(f"servebench: modules {bad} were loaded; no result",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(res["peak"]),
              "power_limit": power_limit()}
    if args.trace:
        device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
    checks = {k: {"value": v, "limit": res["limits"].get(k)}
              for k, v in res["numbers"].items()}
    cell.log(f"compared {res['sampled_rows']} rows of "
             f"{res['attempted']} requests")
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
