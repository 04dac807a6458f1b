"""End-to-end serving example on the PyTorch port: optimize + deploy an
ensemble behind the HTTP server, fire batched client requests at it, report
latency / throughput, then shut down.

Run:  PYTHONPATH=src python examples/torch_serve_ensemble.py
      [--ensemble ENS4] [--port 8650] [--requests 24]
      [--combine mean|weighted|vote|pallas] [--cpu]
On ``--devices`` cells of the CUDA card (``cuda_cells``) unless ``--cpu``
is given (host CPU cells); ``--port 0`` binds a free port.
"""
import argparse
import json
import os
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import (AllocationOptimizer, MeasuredBench,  # noqa: E402
                              cuda_cells, host_cpus)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving.server import serve  # noqa: E402
from repro_torch.serving.system import InferenceSystem  # noqa: E402

SEQ = 16


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ensemble", default="ENS4")
    ap.add_argument("--members", type=int, default=3)
    ap.add_argument("--port", type=int, default=8650)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--combine", default="mean")
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--reconfig", action="store_true",
                    help="attach the online reconfiguration controller "
                         "(live replanning + cross-worker work stealing, "
                         "DESIGN.md §8); its stats appear under "
                         "'controller' in GET /metrics")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on host CPU cells (default: cells of the "
                         "CUDA card)")
    args = ap.parse_args()

    cfgs = ensemble(args.ensemble)[: args.members]
    params = [init_params(c, i, "cpu") for i, c in enumerate(cfgs)]
    print("members:", [c.name for c in cfgs])

    devices = host_cpus(args.devices, memory_bytes=4 * 1024 ** 3) \
        if args.cpu else cuda_cells(args.devices)
    calib = np.random.default_rng(0).integers(
        0, cfgs[0].vocab_size, (64, SEQ)).astype(np.int32)
    bench = MeasuredBench(cfgs, params, calib, segment_size=32)
    result = AllocationOptimizer(cfgs, devices, bench, max_iter=1,
                                 max_neighs=4, batch_sizes=(8, 16),
                                 seq=SEQ).optimize()
    print("allocation:\n" + result.matrix.pretty())

    system = InferenceSystem(cfgs, params, result.matrix, segment_size=32,
                             max_seq=SEQ, combine=args.combine)
    if args.reconfig:
        from repro_torch.serving.control import ReconfigController
        ReconfigController(system, interval_s=2.0,
                           batch_sizes=(8, 16)).start()
        print("reconfig controller attached (replan + work stealing)")
    httpd, batcher = serve(system, port=args.port, max_wait_s=0.05)
    port = httpd.server_address[1]
    print(f"serving on http://127.0.0.1:{port}")

    lat, lock = [], threading.Lock()

    def client(i):
        """Every 4th request is latency-sensitive: it rides /v2/predict with
        priority=high + a deadline; the rest use the v1 /predict shim."""
        x = np.random.default_rng(i).integers(
            0, cfgs[0].vocab_size, (4, SEQ)).tolist()
        high = i % 4 == 0
        path, payload = ("/v2/predict",
                         {"tokens": x, "priority": "high",
                          "deadline_ms": 120_000}) if high \
            else ("/predict", {"tokens": x})
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        y = json.load(urllib.request.urlopen(req))["predictions"]
        with lock:
            lat.append((high, time.perf_counter() - t0))
        assert len(y) == 4

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    wall = time.perf_counter() - t0
    n = args.requests * 4
    print(f"\n{args.requests} concurrent requests x4 samples: "
          f"{n / wall:.1f} samples/s")
    for label, flag in (("high(v2)", True), ("normal(v1)", False)):
        ls = [l for h, l in lat if h is flag]
        if ls:
            print(f"latency[{label}] p50={np.percentile(ls, 50)*1000:.0f}ms "
                  f"p95={np.percentile(ls, 95)*1000:.0f}ms")
    metrics = json.load(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics"))
    print(f"padding efficiency: "
          f"{metrics['counters'].get('padding_efficiency', 1.0):.3f}")
    if args.reconfig and metrics.get("controller"):
        ctl = metrics["controller"]
        print(f"reconfig: generation={ctl['generation']} "
              f"counters={ctl['counters']}")
    httpd.shutdown()
    batcher.stop()
    system.shutdown()


if __name__ == "__main__":
    main()
