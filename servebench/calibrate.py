"""Read the numbers compared with the reference over many seeds in one
process: the program's (the lower readings) and, on the first
``--control`` seeds, the TF32 control's (the upper readings) from which
a configuration's ``check`` limits are set.

    python3 servebench/calibrate.py --workload <name> --seeds 12 \
        --control 3 --seconds 6 [--first 0]

Each seed builds its weights and system anew and runs the cell's traffic
at its own load for ``--seconds``.  One JSON line a seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--first", type=int, default=0)
    args = ap.parse_args()
    run._environment()
    import torch
    from harness import cell
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = cell.load_spec(args.workload, run.ROOT)
    dev = torch.device("cuda", 0)
    for i in range(args.seeds):
        seed = 7_000_003 * (args.first + i + 1) + 2 ** 31
        t = time.perf_counter()
        res = cell.run_cell(spec, seed, args.seconds, False, t_start=t,
                            device=dev, control=i < args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "program": res["numbers"],
                          "control": res["control"],
                          "metrics": res["metrics"],
                          "rows": res["sampled_rows"],
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
