"""Allocation-matrix optimizer walkthrough on the PyTorch port (paper
§II.E, Tables I-III).

Shows Algorithm 1 (worst-fit-decreasing) and Algorithm 2 (bounded greedy) on
the paper-shaped scenario — an ensemble on N simulated GPUs (the H100 row's
rates) + 1 CPU — with the analytic roofline bench, printing the
Table-II-style matrix at each stage and the BBS baseline comparison.  It is
analytic: no device runs anything.

Run:  PYTHONPATH=src python examples/torch_allocation_search.py
          [--ensemble ENS12] [--gpus 4]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import (AllocationMatrix, AllocationOptimizer,  # noqa: E402
                              AnalyticBench, MemoBench, host_cpus,
                              simulated_gpus, worst_fit_decreasing)
from repro_torch.core.bbs import (BBSError, analytic_single_bench,  # noqa: E402
                                  best_batch_strategy)

GiB = 1024 ** 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ensemble", default="ENS4")
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--gpu-mem-mib", type=int, default=150)
    ap.add_argument("--max-iter", type=int, default=10)
    ap.add_argument("--max-neighs", type=int, default=100)
    args = ap.parse_args()

    cfgs = ensemble(args.ensemble)
    devices = simulated_gpus(args.gpus,
                             memory_bytes=args.gpu_mem_mib * 1024 ** 2) + \
        host_cpus(1, memory_bytes=1 * GiB)
    print(f"{len(cfgs)} models on {args.gpus} GPUs + 1 CPU")
    print("decision space (Eq. 1): "
          f"{AllocationMatrix.total_matrices(len(devices), len(cfgs), 5):.2e} matrices\n")

    bench = MemoBench(AnalyticBench(cfgs, seq=128))

    wfd = worst_fit_decreasing(cfgs, devices)
    print(f"Algorithm 1 (worst-fit-decreasing): {bench(wfd):.0f} samples/s")
    print(wfd.pretty(), "\n")

    opt = AllocationOptimizer(cfgs, devices, bench, max_iter=args.max_iter,
                              max_neighs=args.max_neighs)
    res = opt.optimize()
    print(f"Algorithm 2 (bounded greedy, {res.trace.evaluated} benches, "
          f"{res.trace.iterations} iterations): {res.final_score:.0f} samples/s "
          f"({res.final_score / max(res.wfd_score, 1e-9):.2f}x)")
    print(res.matrix.pretty(), "\n")
    print("greedy score trajectory:",
          [round(s) for s in res.trace.scores])

    try:
        bbs, nb = best_batch_strategy(cfgs, devices,
                                      analytic_single_bench(seq=128))
        print(f"\nBBS baseline ({nb} benches): {bench(bbs):.0f} samples/s "
              f"-> our speedup {res.final_score / max(bench(bbs), 1e-9):.2f}x")
    except BBSError as e:
        print(f"\nBBS baseline inapplicable: {e}")


if __name__ == "__main__":
    main()
