"""Serving launcher: optimize an ensemble allocation over allocation cells
and start the inference server.

The cells are ``core.devices.cuda_cells(--cells)``: each visible card split
into ``--cells`` cells.  ``--cpu`` asks for ``host_cpus(--cells,
--cell-mem-gib)`` instead; without it the launcher runs on the card or fails.

    python -m repro_torch.launch.serve --ensemble ENS4 --cells 2 --port 8600
    python -m repro_torch.launch.serve --cpu --ensemble ENS4 --members 2

With ``--port 0`` the server binds a free port and the launcher prints it.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ensemble", default="ENS4")
    ap.add_argument("--members", type=int, default=0)
    ap.add_argument("--cells", type=int, default=2)
    ap.add_argument("--cell-mem-gib", type=float, default=4.0,
                    help="memory budget of each CPU cell (with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on host CPU cells instead of the card")
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--segment-size", type=int, default=32)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--combine", default="mean")
    ap.add_argument("--member-dtype", default="fp32",
                    help="member execution precision (DESIGN.md §14): one "
                         "value for all members (fp32|bf16|int8|fp8) or a "
                         "comma-separated per-member list, e.g. "
                         "'int8,int8,fp32,fp32'.  Quantized members store "
                         "params narrow (per-output-channel scales), pack "
                         "~2x denser in the allocator, and feed the fused "
                         "dequant-combine epilogue")
    ap.add_argument("--dispatch-queue", default="fifo",
                    choices=("fifo", "edf"),
                    help="predictor dispatch order: fifo = strict priority "
                         "then arrival; edf = earliest-deadline-first "
                         "within priority class (simulator-validated, "
                         "DESIGN.md §12)")
    ap.add_argument("--bench", default="measured", choices=("measured", "analytic"))
    ap.add_argument("--duration", type=float, default=0.0,
                    help="serve for N seconds then exit (0 = forever)")
    ap.add_argument("--linger", default="fixed", choices=("fixed", "adaptive"),
                    help="adaptive scales the coalescing linger down with "
                         "queue depth (DESIGN.md §7)")
    ap.add_argument("--max-wait-us", type=int, default=500,
                    help="coalescing linger bound per open batch slot")
    ap.add_argument("--dispatch-ahead", type=int, default=0,
                    help="committed (non-preemptible) chunk window per "
                         "worker: small (1-2) favors high-priority latency, "
                         "large favors throughput; 0 = library default "
                         "(DESIGN.md §3)")
    ap.add_argument("--cache-capacity", type=int, default=0,
                    help="rows in the prediction cache (0 disables)")
    ap.add_argument("--reconfig", action="store_true",
                    help="run the online reconfiguration controller: live "
                         "replanning against the EWMA workload profile plus "
                         "cross-worker work stealing (DESIGN.md §8)")
    ap.add_argument("--reconfig-interval", type=float, default=5.0,
                    help="seconds between live replans (with --reconfig)")
    ap.add_argument("--steal-threshold", type=int, default=4,
                    help="queue-depth gap between data-parallel siblings "
                         "that triggers work stealing (with --reconfig)")
    ap.add_argument("--no-steal", action="store_true",
                    help="disable the work-stealing fast path (replanning "
                         "only, with --reconfig)")
    # fault tolerance (DESIGN.md §10)
    ap.add_argument("--no-supervise", action="store_true",
                    help="disable worker supervision and fall back to the "
                         "paper's all-or-nothing failure model: any worker "
                         "crash fails every in-flight request and shuts the "
                         "system down (§II.C.2)")
    ap.add_argument("--watchdog-s", type=float, default=5.0,
                    help="a worker stage mid-work longer than this is "
                         "declared stalled and its instance quarantined")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="max times one request's chunks may be resubmitted "
                         "after worker failures before it fails with "
                         "RetriesExhausted (HTTP 503)")
    ap.add_argument("--nan-guard", action="store_true",
                    help="check materialized device outputs for NaN; a "
                         "poisoned output crashes its worker (quarantine + "
                         "replay on a sibling) instead of folding into Y")
    ap.add_argument("--fault", action="append", default=[],
                    metavar="SPEC",
                    help="inject a deterministic fault for chaos testing; "
                         "repeatable.  SPEC is key=value pairs: "
                         "stage=batcher|predictor|sender|spawn "
                         "[kind=raise|stall|nan|slow] [after=N] [stall_s=S] "
                         "[repeat=true] [worker=ID-prefix], e.g. "
                         "--fault stage=predictor,after=100,worker=w0.0 or "
                         "a sustained overload drill: "
                         "--fault stage=predictor,kind=slow,stall_s=0.004")
    # overload robustness (DESIGN.md §11)
    ap.add_argument("--brownout", action="store_true",
                    help="run the brownout controller: continuous pressure "
                         "signal from queue depths / p99 / loss counters, "
                         "hysteresis into discrete levels, each serving a "
                         "cheaper member-subset quality tier; plus cost-"
                         "aware admission (429 + computed Retry-After on "
                         "infeasible deadlines)")
    ap.add_argument("--tier-table", default=None,
                    help="explicit brownout tiers as semicolon-separated "
                         "member-id lists, level 0 first, e.g. "
                         "'0,1,2;0,1;0'; default derives tiers from "
                         "per-member cost/weight ratios (EARN-style)")
    ap.add_argument("--brownout-deadline-ms", type=float, default=None,
                    help="latency budget the pressure signal compares the "
                         "normal-class p99 against (default: none — queue "
                         "depth and loss counters drive pressure)")
    ap.add_argument("--cascade-margin", type=float, default=None,
                    help="confidence-gated cascade: tier results whose "
                         "top1-top2 margin falls below this escalate to the "
                         "dropped members (with --brownout)")
    # simulation / planning (DESIGN.md §12)
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="append every offered request to PATH as JSONL "
                         "(t, rows, priority, deadline_ms, members) for "
                         "offline replay: benchmarks/serving_hotpath.py "
                         "--replay-trace or the discrete-event simulator "
                         "(the JAX package's repro.serving.sim)")
    ap.add_argument("--admission-budget-mib", type=float, default=0.0,
                    help="global in-flight input-byte budget; requests "
                         "beyond it are refused with 429 + Retry-After "
                         "instead of queuing unboundedly (0 disables)")
    # observability / tracing (DESIGN.md §13)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing and write the flight "
                         "recorder as Chrome-trace / Perfetto JSON to PATH "
                         "at shutdown (also live at GET /v2/trace); open "
                         "it at https://ui.perfetto.dev")
    ap.add_argument("--flight-recorder", type=int, default=0, metavar="N",
                    help="per-track flight-recorder ring capacity in "
                         "events (enables tracing without --trace-out; "
                         "anomalies — watchdog stalls, deadline-miss "
                         "bursts, brownout shifts, exhausted retries — "
                         "freeze tagged dumps at GET /v2/trace?dumps=1; "
                         "0 = off unless --trace-out, default ring 4096)")
    args = ap.parse_args(argv)

    import numpy as np
    from repro_torch.configs import ensemble
    from repro_torch.core import (AllocationOptimizer, AnalyticBench,
                                  MeasuredBench, cuda_cells, host_cpus)
    from repro_torch.models import init_params
    from repro_torch.serving.request_cache import PredictionCache
    from repro_torch.serving.server import serve
    from repro_torch.serving.system import InferenceSystem

    cfgs = ensemble(args.ensemble)
    if args.members:
        cfgs = cfgs[: args.members]
    from repro_torch.kernels.quant import validate_member_dtype
    dts = [d.strip() for d in args.member_dtype.split(",") if d.strip()]
    if len(dts) == 1:
        dts = dts * len(cfgs)
    if len(dts) != len(cfgs):
        ap.error(f"--member-dtype expects 1 or {len(cfgs)} values, "
                 f"got {len(dts)}")
    member_dtypes = [validate_member_dtype(d) for d in dts]
    # one seed per member; the trees stay on the host, and each worker
    # moves its own copy onto its cell's device
    params = [init_params(c, i, "cpu") for i, c in enumerate(cfgs)]

    if args.cpu:
        devices = host_cpus(args.cells,
                            memory_bytes=int(args.cell_mem_gib * 1024 ** 3))
    else:
        devices = cuda_cells(args.cells)

    calib = np.random.default_rng(0).integers(
        0, cfgs[0].vocab_size, (64, args.seq)).astype(np.int32)
    if args.bench == "measured":
        bench = MeasuredBench(cfgs, params, calib,
                              segment_size=args.segment_size)
        opt = AllocationOptimizer(cfgs, devices, bench, max_iter=1,
                                  max_neighs=4, batch_sizes=(8, 16),
                                  seq=args.seq,
                                  cache_path=".repro_alloc_cache.json",
                                  member_dtypes=member_dtypes)
    else:
        bench = AnalyticBench(cfgs, seq=args.seq,
                              member_dtypes=member_dtypes)
        opt = AllocationOptimizer(cfgs, devices, bench, max_iter=10,
                                  max_neighs=100, seq=args.seq,
                                  cache_path=".repro_alloc_cache.json",
                                  member_dtypes=member_dtypes)
    res = opt.optimize()
    print("allocation matrix:\n" + res.matrix.pretty())
    print(f"bench: A1={res.wfd_score:.1f} -> A2={res.final_score:.1f} "
          f"samples/s{' (cached)' if res.from_cache else ''}")

    fault_plan = None
    if args.fault:
        from repro_torch.serving.faults import FaultPlan, FaultSpec
        fault_plan = FaultPlan(*[FaultSpec.parse(s) for s in args.fault])
        print(f"fault injection armed: {args.fault}")
    budget = None
    if args.admission_budget_mib:
        from repro_torch.serving.admission import AdmissionBudget
        budget = AdmissionBudget(
            max_bytes=int(args.admission_budget_mib * 1024 ** 2))
    trace_cap = args.flight_recorder or (4096 if args.trace_out else 0)
    system = InferenceSystem(cfgs, params, res.matrix,
                             segment_size=args.segment_size,
                             max_seq=args.seq, combine=args.combine,
                             max_wait_us=args.max_wait_us,
                             linger=args.linger,
                             dispatch_ahead=args.dispatch_ahead or None,
                             supervise=not args.no_supervise,
                             watchdog_s=args.watchdog_s,
                             retry_budget=args.retry_budget,
                             nan_guard=args.nan_guard,
                             fault_plan=fault_plan,
                             admission_budget=budget,
                             tracing=trace_cap > 0,
                             trace_capacity=trace_cap or 4096,
                             member_dtypes=member_dtypes,
                             dispatch_queue=args.dispatch_queue)
    if any(d != "fp32" for d in member_dtypes):
        print(f"member dtypes: {','.join(member_dtypes)} (quantized members "
              f"run the fused dequant-combine epilogue)")
    if args.dispatch_queue != "fifo":
        print(f"dispatch queue: {args.dispatch_queue}")
    if trace_cap:
        print(f"span tracing on (flight recorder {trace_cap} events/track; "
              f"GET /v2/trace, anomaly dumps at ?dumps=1)")
    if not args.no_supervise:
        print(f"supervision on (watchdog {args.watchdog_s:.1f}s, retry "
              f"budget {args.retry_budget}); worker failures quarantine the "
              f"instance — health gauges in GET /metrics")
    controller = None
    if args.reconfig:
        from repro_torch.serving.control import ReconfigController
        controller = ReconfigController(
            system, interval_s=args.reconfig_interval,
            steal_threshold=args.steal_threshold,
            steal=not args.no_steal, batch_sizes=(8, 16, 32)).start()
        print(f"reconfig controller on (replan every "
              f"{args.reconfig_interval:.1f}s, steal "
              f"{'off' if args.no_steal else 'on'}; see GET /metrics "
              f"'controller')")
    brownout = None
    if args.brownout:
        from repro_torch.serving.control import BrownoutController
        tiers = None
        if args.tier_table:
            tiers = [tuple(int(m) for m in level.split(","))
                     for level in args.tier_table.split(";") if level.strip()]
        brownout = BrownoutController(
            system, tiers=tiers,
            deadline_budget_ms=args.brownout_deadline_ms,
            cascade_margin=args.cascade_margin).start()
        print(f"brownout controller on ({len(brownout.tiers())} quality "
              f"tiers; see GET /metrics 'brownout')")
    if budget is not None:
        print(f"admission budget: {args.admission_budget_mib:.1f} MiB "
              f"in-flight input bytes (429 + Retry-After beyond it)")
    recorder = None
    if args.record_trace:
        from repro_torch.serving.trace import TraceRecorder
        recorder = TraceRecorder(path=args.record_trace)
        system.trace_recorder = recorder
        print(f"recording request trace to {args.record_trace}")
    cache = PredictionCache(args.cache_capacity) if args.cache_capacity else None
    httpd, batcher = serve(system, port=args.port, cache=cache)
    port = httpd.server_address[1]
    print(f"serving {len(cfgs)} models / {len(system.workers)} workers on "
          f"http://127.0.0.1:{port}  (POST /v2/predict with priority/"
          f"deadline_ms/members, GET /metrics; POST /predict = v1 shim)",
          flush=True)
    try:
        if args.duration:
            time.sleep(args.duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        batcher.stop()
        system.shutdown()
        if recorder is not None:
            recorder.close()
            print(f"trace: {len(recorder.events())} requests recorded to "
                  f"{args.record_trace}")
        if args.trace_out:
            import json
            trace = system.tracer.export()
            with open(args.trace_out, "w") as f:
                json.dump(trace, f)
            print(f"span timeline: {len(trace['traceEvents'])} events "
                  f"written to {args.trace_out} (open at "
                  f"https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
