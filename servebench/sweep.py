"""Find the highest rate an open mix sustains on a configuration: one
system, built once, serves the mix at each rate in turn for ``--seconds``.

    python3 servebench/sweep.py --config mamba2-pair --traffic open-4.0rps \
        --rates 3,4,5,6 --seconds 20

Per rate one JSON line: requests, the rate completed, p50 and p95
latency, and the backlog's trend: the mean latency of the window's last
quarter of requests over its first quarter's (about 1 where the queue is
steady, growing with the window where it is not), and how long after the
window the last answer came.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 99)
    args = ap.parse_args()
    run._environment()
    import torch
    from harness import cell, stats, traffic, weights
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    bench = run.BENCH
    cfg = json.loads((bench / "configs" / f"{args.config}.json").read_text())
    mix = json.loads((bench / "traffic" / f"{args.traffic}.json").read_text())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = weights.make_trees(cfg, args.seed, dev)
    system = cell.build_system(cfg, trees, dev, tracing=False)
    try:
        traffic.warm(system, mix, cfg)
        for rate in (float(r) for r in args.rates.split(",")):
            spec = dict(mix, rate_rps=rate)
            system.timers.reset()
            t0 = time.perf_counter()
            reqs = traffic.run(system, spec, cfg, args.seed, t0, args.seconds)
            lat = [r.latency_s for r in reqs]
            q = max(1, len(reqs) // 4)
            done = [r.done for r in reqs if r.ok]
            c = system.serving_counters()
            print(json.dumps({
                "config": args.config, "rate_rps": rate,
                "requests": len(reqs),
                "failed": sum(not r.ok for r in reqs),
                "completed_rps": (len(done) - 1) / (max(done) - min(done)),
                "p50_ms": 1e3 * stats.percentile(lat, 50),
                "p95_ms": 1e3 * stats.percentile(lat, 95),
                "trend": (sum(lat[-q:]) / q) / (sum(lat[:q]) / q),
                "drain_s": max(done) - (t0 + args.seconds),
                "rows_per_batch": c.get("rows_valid", 0) /
                max(1, c.get("batches", 0)),
                "padding_efficiency": c.get("padding_efficiency")}),
                flush=True)
    finally:
        system.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
