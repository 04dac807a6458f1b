"""Quickstart on the PyTorch port: the paper's whole pipeline.

1. Build a heterogeneous ensemble of (reduced) assigned-pool LMs.
2. Optimize the allocation matrix (Algorithm 1 -> Algorithm 2).
3. Deploy the asynchronous inference system behind the EnsembleClient
   facade and serve predictions — sync, with per-request options
   (priority / deadline / member subset), streaming per-segment partials,
   and a prediction cache.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--cpu]
On the CUDA card (two allocation cells of card 0, ``cuda_cells(2)``)
unless ``--cpu`` is given (two host CPU cells).  The parameter trees are
built on the host from seeds; each worker copies its member's tree to its
cell's device.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import (AllocationOptimizer, MeasuredBench,  # noqa: E402
                              cuda_cells, host_cpus)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import (EnsembleClient, PredictionCache,  # noqa: E402
                                 PredictOptions, InferenceSystem)

SEQ = 16


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="serve on two host CPU cells (default: two cells "
                         "of the CUDA card)")
    args = ap.parse_args()

    # 1. the ensemble: 2 heterogeneous members (fast demo; see
    #    torch_serve_ensemble for the full ENS4/ENS12 setups)
    cfgs = ensemble("ENS4")[:2]
    params = [init_params(c, i, "cpu") for i, c in enumerate(cfgs)]
    print("ensemble:", [c.name for c in cfgs])

    # 2. optimize the allocation matrix on 2 cells
    devices = host_cpus(2, memory_bytes=4 * 1024 ** 3) if args.cpu \
        else cuda_cells(2)
    print("cells:", [d.name for d in devices])
    calib = np.random.default_rng(0).integers(
        0, cfgs[0].vocab_size, (64, SEQ)).astype(np.int32)
    bench = MeasuredBench(cfgs, params, calib, segment_size=32)
    opt = AllocationOptimizer(cfgs, devices, bench, max_iter=1, max_neighs=4,
                              batch_sizes=(8, 16), seq=SEQ)
    result = opt.optimize()
    print(f"\nAlgorithm 1 (worst-fit) throughput: {result.wfd_score:.1f} samples/s")
    print(f"Algorithm 2 (greedy)    throughput: {result.final_score:.1f} samples/s")
    print("\nallocation matrix (paper Table II style):")
    print(result.matrix.pretty())

    # 3. deploy and serve through the one request facade
    X = np.random.default_rng(1).integers(
        0, cfgs[0].vocab_size, (40, SEQ)).astype(np.int32)
    with InferenceSystem(cfgs, params, result.matrix, segment_size=32,
                         max_seq=SEQ) as system:
        client = EnsembleClient(system, cache=PredictionCache(capacity=1024))

        # sync, full ensemble
        Y = client.predict(X)
        print(f"\nserved {X.shape[0]} samples -> ensemble predictions {Y.shape}")
        print("top-1 classes of first 8 samples:", Y[:8].argmax(1).tolist())

        # per-request options: a latency-sensitive call on a member subset
        # with a deadline — jumps the admission queue, fails fast if late
        y_fast = client.predict(X[:4], PredictOptions(
            priority="high", deadline_ms=10_000, members=[0]))
        print("member-0-only (high priority):", y_fast.argmax(1).tolist())

        # streaming partials: segments arrive as their ensemble rows close
        done = []
        client.predict_stream(
            X, lambda s, lo, hi, Y_seg: done.append((s, hi - lo))
        ).result(60.0)
        print("streamed segments (id, rows):", sorted(done))

        # redundant requests are answered from the cache
        client.predict(X)
        print("cache after repeat:", client.metrics()["cache"])

    # 4. fault tolerance (DESIGN.md §10): with supervise=True a worker
    #    failure is contained to its instance instead of the paper's
    #    all-or-nothing shutdown.  Inject a deterministic crash into one of
    #    member 0's two data-parallel siblings: the supervisor quarantines
    #    it and replays its outstanding chunks on the survivor — zero lost
    #    requests, full quality.  With tracing=True the flight recorder
    #    (DESIGN.md §13) captures the whole drill as per-chunk span
    #    timelines — the quarantine and chunk replay show up as annotated
    #    instants on the admission track.
    import tempfile
    from repro_torch.core import AllocationMatrix
    from repro_torch.serving import FaultPlan, FaultSpec
    alloc = AllocationMatrix(devices, [c.name for c in cfgs],
                             np.array([[8, 8], [8, 0]]))
    fp = FaultPlan(FaultSpec(stage="predictor", kind="raise", after=2,
                             worker="w1.0"))
    with InferenceSystem(cfgs, params, alloc, segment_size=32, max_seq=SEQ,
                         supervise=True, watchdog_s=5.0, retry_budget=2,
                         fault_plan=fp, tracing=True) as system:
        hs = [system.predict_async(X) for _ in range(6)]
        quals = [(h.result(120.0).shape[0], h.quality) for h in hs]
        c = system.serving_counters()
        print(f"\nfault injected: worker_crashes="
              f"{c.get('worker_crashes', 0):.0f} "
              f"quarantines={c.get('quarantines', 0):.0f} "
              f"segments_replayed={c.get('segments_replayed', 0):.0f}")
        print("all requests served at quality:", [q for _, q in quals])
        # dump the drill's trace as Chrome-trace / Perfetto JSON — open it
        # at https://ui.perfetto.dev (or chrome://tracing) to see each
        # request's admission -> pack -> dispatch -> predict -> transfer ->
        # combine timeline, with the replay annotations on the faulted
        # worker.  A live deployment serves the same JSON at GET /v2/trace
        # (serve.py --trace-out / --flight-recorder).
        trace_path = os.path.join(tempfile.gettempdir(),
                                  "fault_drill_trace.json")
        trace = EnsembleClient(system).dump_trace(trace_path)
        replay = [e for e in trace["traceEvents"]
                  if e.get("name") == "quarantine_replay"]
        print(f"flight recorder: {len(trace['traceEvents'])} events -> "
              f"{trace_path} (quarantine_replay instants: {len(replay)}; "
              f"load it at https://ui.perfetto.dev)")

    # 5. overload brownout (DESIGN.md §11): when offered load outruns
    #    capacity, the BrownoutController degrades *quality* instead of
    #    latency — it folds queue depth / p99 / loss counters into one
    #    pressure signal and, through hysteresis, serves cheaper member
    #    subsets (accuracy-elastic tiers).  Drive the control law by hand:
    from repro_torch.serving import BrownoutController
    with InferenceSystem(cfgs, params, alloc, segment_size=32,
                         max_seq=SEQ) as system:
        ctl = BrownoutController(system, tiers=[(0, 1), (0,)],
                                 demote_inflight=False, feasibility=False)
        ctl.step(2.0)
        ctl.step(2.0)               # two high-pressure ticks: level 1
        h = system.predict_async(X)         # planned against the cheap tier
        Y_tier = h.result(60.0)
        print(f"\nbrownout drill: level={ctl.level} "
              f"tier quality={h.quality:.2f} "
              f"(served {Y_tier.shape[0]} rows on the cheap member)")
        for _ in range(10):
            ctl.step(0.0)           # sustained calm: back to level 0
        print(f"recovered to level {ctl.level}; "
              f"stats={ {k: v for k, v in ctl.stats().items() if k != 'tiers'} }")

    # 6. record a trace, replay it in the simulator (DESIGN.md §12):
    #    attach a TraceRecorder to the live system, then re-run the exact
    #    offered load through the discrete-event model — the same policy
    #    code under a virtual clock, so what-ifs (a different allocation,
    #    dispatch-ahead K, the EDF prototype) answer in milliseconds.
    from repro_torch.serving.sim import ServiceModel, SimSystem, WorkerSpec
    from repro_torch.serving.trace import TraceRecorder
    with InferenceSystem(cfgs, params, alloc, segment_size=32,
                         max_seq=SEQ) as system:
        rec = TraceRecorder()               # or launch/serve.py --record-trace
        system.trace_recorder = rec
        client = EnsembleClient(system)
        client.predict(X)
        client.predict(X[:4], PredictOptions(priority="high", members=[0]))
    svc = ServiceModel.from_delays({0: 500, 1: 500})   # 500us per chunk
    sim = SimSystem(svc, [WorkerSpec(0, 16), WorkerSpec(1, 16)],
                    segment_size=32).run(rec.events())
    r = sim.results()
    print(f"\nreplayed {r['offered']} recorded requests in-sim: "
          f"completed={r['completed']} p99={r['p99_ms']:.2f}ms "
          f"(deterministic)")

    # 7. quantized members (DESIGN.md §14): int8 params with per-channel
    #    scales pack ~2-4x more members per device and feed the fused
    #    dequant-weight-accumulate combine epilogue (the
    #    ensemble_combine_quant kernel on the card); outputs stay within
    #    int8 tolerance of fp32.  From the CLI the same knob is
    #    `python -m repro_torch.launch.serve --member-dtype int8` (or a
    #    per-member list like `--member-dtype int8,fp32`).
    with InferenceSystem(cfgs, params, alloc, segment_size=32, max_seq=SEQ,
                         member_dtypes=["int8", "int8"],
                         combine="pallas") as system:
        Y_q = EnsembleClient(system).predict(X)
        agree = float((Y_q.argmax(1) == Y.argmax(1)).mean())
        print(f"\nquantized ensemble (int8 + fused combine): "
              f"{Y_q.shape[0]} rows, top-1 agreement vs fp32 "
              f"{agree:.2f}")

    # Going further: the allocation above is frozen at deploy time.  When
    # the live workload drifts (one member runs hot, traffic spikes), attach
    # the online reconfiguration controller — live replanning + instance
    # migration + cross-worker work stealing (DESIGN.md §8):
    #     python examples/torch_serve_ensemble.py --reconfig
    #     python -m repro_torch.launch.serve --reconfig
    # The serving launcher runs supervised by default; the fault-tolerance
    # knobs (DESIGN.md §10) are --no-supervise, --watchdog-s,
    # --retry-budget, --nan-guard, and repeatable --fault SPECs for chaos
    # drills, e.g.:
    #     python -m repro_torch.launch.serve \
    #         --fault stage=predictor,after=100,worker=w0.0
    # Overload robustness (DESIGN.md §11) adds --brownout, --tier-table,
    # --cascade-margin and --admission-budget-mib; a sustained-overload
    # drill slows one member and watches the 'brownout' block in /metrics:
    #     python -m repro_torch.launch.serve --brownout \
    #         --admission-budget-mib 64 \
    #         --fault stage=predictor,kind=slow,stall_s=0.004,worker=w1


if __name__ == "__main__":
    main()
