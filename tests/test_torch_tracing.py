"""The PyTorch port's end-to-end tracing, ported from tests/test_tracing.py
(DESIGN.md §13): flight-recorder ring
bounds and stride realignment, grouped-record decode and the pack-instant
join that recovers per-chunk request attribution, Perfetto JSON export
round-trips, anomaly-triggered dumps, connected admission→combine
timelines on a live fake-device system, control-plane annotation instants
(steal / quarantine replay / demotion / cancellation), sim-vs-live span
comparability on the virtual clock, and the Prometheus metrics surface
(text exposition, log-bucket latency histograms, the gauge-insert race);
plus the simulator's trace export, equal to the JAX package's on the same
trace; and the serving path's own waits and device timing (ring-slot
wait, admission wait, the device partial's post, each forward's device
time and its ``<worker>/device`` span).
"""
import json
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving.metrics import (LATENCY_BOUNDS_S,  # noqa: E402
                                         StageTimers, prometheus_text)
from repro_torch.serving.segments import RequestCancelled  # noqa: E402
from repro_torch.serving.system import InferenceSystem  # noqa: E402
from repro_torch.serving.tracing import (FlightRecorder, Tracer,  # noqa: E402
                                         _decode, pack_times)

SEQ = 16


def _X(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 64, (n, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def ens2():
    cfgs = ensemble("ENS4")[:2]
    return cfgs, [init_params(c, i, "cpu") for i, c in enumerate(cfgs)]


def make_system(cfgs, params, A, **kw):
    A = np.array(A)
    devs = host_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs], A)
    kw.setdefault("max_seq", SEQ)
    kw.setdefault("fake", True)
    kw.setdefault("tracing", True)
    return InferenceSystem(cfgs, params, alloc, **kw)


def _names(trace):
    return {ev["name"] for ev in trace["traceEvents"] if ev["ph"] != "M"}


# ---- flight recorder --------------------------------------------------------

def test_ring_bounds_drop_oldest():
    r = FlightRecorder(capacity=8)
    for i in range(20):
        r.append(("X", f"ev{i}", float(i), 0.5, i, None, None, None))
    assert len(r) == 8
    events = r.snapshot()
    assert [e[1] for e in events] == [f"ev{i}" for i in range(12, 20)]
    r.clear()
    assert len(r) == 0 and r.snapshot() == []


def test_snapshot_realigns_misaligned_copy():
    # a copy that starts mid-event (torn by a concurrent wrap) must be
    # re-chunked from the ph column, not decoded off-by-k
    r = FlightRecorder(capacity=8)
    r._ring.extend((1.0, 2.0, 3.0))        # stray half-event prefix
    for i in range(3):
        r.append(("X", f"ev{i}", float(i), 0.1, i, None, None, None))
    events = r.snapshot()
    assert [e[1] for e in events] == ["ev0", "ev1", "ev2"]
    assert all(e[0] == "X" for e in events)


# ---- flat-event decode ------------------------------------------------------

def test_decode_grouped_dispatch_round():
    ts = (1.0, 2.0, 3.0)
    ph, name, t0, dur, rid, args = _decode(
        "G", "dispatch_wait", 1.0, 5.0, None, pack_times(ts), 0.25, 3)
    assert (ph, name, rid) == ("G", "dispatch_wait", None)
    assert args == {"t_enq": ts, "predict_dur": 0.25, "chunks": 3}
    # uncommitted round: no predict attached
    _, _, _, _, _, args = _decode(
        "G", "dispatch_wait", 1.0, 5.0, None, pack_times(ts), None, None)
    assert args == {"t_enq": ts}


def test_decode_grouped_single_span():
    # correlation-key form (slot a = the round's pop time) ...
    _, _, _, _, _, args = _decode("g", "transfer", 6.0, 0.5, None, 5.0, 2,
                                  None)
    assert args == {"t_pop": 5.0, "chunks": 2}
    # ... and the inline packed-times form
    _, _, _, _, _, args = _decode("g", "transfer", 6.0, 0.5, None,
                                  pack_times((1.5,)), 1, None)
    assert args == {"t_enq": (1.5,), "chunks": 1}


def test_decode_slot_keys_and_passthrough():
    assert _decode("X", "combine", 0.0, 0.1, 7, 2, 1, True)[5] == \
        {"s": 2, "m": 1, "posted": True}
    assert _decode("X", "accumulate", 0.0, 0.1, 7, 3, 64, None)[5] == \
        {"s": 3, "rows": 64}
    assert _decode("i", "pack", 0.0, 0.0, 1, 16, 0, None)[5] == \
        {"chunks": 16, "level": 0}
    assert _decode("i", "complete", 0.0, 0.0, 1, None, None, None)[5] is None
    assert _decode("i", "demote", 0.0, 0.0, 1, {"drop": [1]}, None,
                   None)[5] == {"drop": [1]}


# ---- the pack-instant join --------------------------------------------------

def _joined_tracer():
    """Hand-built worker tracks exercising the export-time join: two
    flushes (rid 1, then rids 2+3 coalesced), one grouped dispatch round
    covering both, one grouped transfer keyed by the round's pop time."""
    tr = Tracer(enabled=True, capacity=64)
    tr.ring("w0/batcher").append(("i", "pack", 10.0, 0.0, 1, 1, 0, None))
    tr.ring("w0/batcher").append(("i", "pack", 11.0, 0.0, (2, 3), 1, 0, None))
    tr.ring("w0/predict").append(
        ("G", "dispatch_wait", 10.0, 12.0, None, pack_times((10.0, 11.0)),
         0.5, 2))
    tr.ring("w0/sender").append(("g", "transfer", 13.0, 0.2, None, 12.0, 2,
                                 None))
    tr.ring("accumulator").append(("i", "complete", 14.0, 0.0, 1, None,
                                   None, None))
    return tr


def test_timeline_resolves_grouped_records_per_rid():
    tr = _joined_tracer()
    tl1 = tr.timeline(1)
    names1 = [(tid, name) for tid, _ph, name, _t0, _dur in tl1]
    assert ("w0/predict", "dispatch_wait") in names1
    assert ("w0/predict", "predict") in names1
    assert ("w0/sender", "transfer") in names1
    assert ("accumulator", "complete") in names1
    # rid 1's chunk waited 10.0 -> 12.0; rid 2 only sees the 11.0 chunk
    dw1 = [(t0, dur) for _tid, _ph, n, t0, dur in tl1 if n == "dispatch_wait"]
    assert dw1 == [(10.0, 2.0)]
    dw2 = [(t0, dur) for _tid, _ph, n, t0, dur in tr.timeline(2)
           if n == "dispatch_wait"]
    assert dw2 == [(11.0, 1.0)]
    assert not any(n == "complete" for _t, _p, n, _a, _b in tr.timeline(2))
    # sorted by start, rooted at the earliest event
    assert [e[3] for e in tl1] == sorted(e[3] for e in tl1)


def test_export_attributes_grouped_records():
    trace = _joined_tracer().export()
    by_name = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] != "M":
            by_name.setdefault(ev["name"], []).append(ev)
    dws = sorted(by_name["dispatch_wait"], key=lambda e: e["ts"])
    assert len(dws) == 2 and all(e["ph"] == "X" for e in dws)
    assert dws[0]["args"] == {"rid": 1}
    assert dws[1]["args"] == {"rids": [2, 3]}
    # the attached predict span and the two-hop transfer join see the
    # union of the round's requests
    assert by_name["predict"][0]["args"] == {"rids": [1, 2, 3], "chunks": 2}
    assert by_name["transfer"][0]["args"] == {"rids": [1, 2, 3], "chunks": 2}
    # ts/dur rebased to the earliest event, in microseconds
    assert dws[0]["ts"] == 0.0 and dws[0]["dur"] == pytest.approx(2e6)


def test_wrapped_pack_instant_resolves_to_no_rid():
    # bounded-recorder semantics: a chunk whose pack instant fell off the
    # ring keeps its span but loses request attribution
    tr = Tracer(enabled=True, capacity=64)
    tr.ring("w0/predict").append(
        ("G", "dispatch_wait", 10.0, 12.0, None, pack_times((10.0,)),
         None, None))
    ev = [e for e in tr.export()["traceEvents"] if e["ph"] == "X"]
    assert len(ev) == 1 and ev[0]["args"] == {}
    assert tr.timeline(1) == []


# ---- export schema / anomaly dumps ------------------------------------------

def test_export_json_roundtrip_and_schema():
    tr = _joined_tracer()
    trace = json.loads(json.dumps(tr.export()))
    assert set(trace) == {"traceEvents", "displayTimeUnit", "metadata"}
    phs = {ev["ph"] for ev in trace["traceEvents"]}
    assert phs <= {"M", "X", "i"}          # grouped records never leak
    tids = {ev["tid"] for ev in trace["traceEvents"]}
    track_names = {ev["args"]["name"] for ev in trace["traceEvents"]
                   if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert track_names == {"w0/batcher", "w0/predict", "w0/sender",
                           "accumulator"}
    assert len(tids) == len(track_names) + 1   # + the process row
    assert trace["metadata"]["clock"] == "perf_counter"


def test_virtual_clock_tagged_in_metadata():
    tr = Tracer(enabled=True, clock=lambda: 5.0)
    assert tr.export()["metadata"]["clock"] == "virtual"


def test_anomaly_dumps_tagged_and_bounded():
    t = [0.0]
    tr = Tracer(enabled=True, capacity=64, clock=lambda: t[0], max_dumps=2,
                burst_n=3, burst_window_s=1.0)
    tr.span("w0/predict", "predict", 0.0, 0.5, rid=1)
    for t[0] in (0.0, 0.1, 0.2):           # 3 misses inside the window
        tr.note_deadline_miss()
    assert [d["metadata"]["dump_trigger"]["trigger"] for d in tr.dumps()] \
        == ["deadline_miss_burst"]
    t[0] = 0.3                             # rate-limited within the window
    tr.note_deadline_miss()
    assert len(tr.dumps()) == 1
    # the dump snapshots the spans leading up to the anomaly
    assert "predict" in _names(tr.dumps()[0])
    for t[0] in (2.0, 2.05, 2.1):          # fresh burst after the window
        tr.note_deadline_miss()
    assert len(tr.dumps()) == 2
    tr.anomaly("watchdog_stall", "w0")     # bounded: oldest dump evicted
    dumps = tr.dumps()
    assert len(dumps) == 2
    assert dumps[-1]["metadata"]["dump_trigger"]["trigger"] == \
        "watchdog_stall"
    assert [a["trigger"] for a in tr.anomalies()] == \
        ["deadline_miss_burst", "deadline_miss_burst", "watchdog_stall"]


def test_disabled_tracer_is_inert():
    tr = Tracer(enabled=False)
    tr.span("w0/predict", "predict", 0.0, 0.5, rid=1)
    tr.instant("admission", "demote", rid=1)
    tr.note_deadline_miss()
    assert tr.anomaly("watchdog_stall") is None
    assert tr.tracks() == {} and tr.dumps() == []


# ---- live system: connected timelines + control-plane annotations -----------

def test_live_timelines_connected_and_exportable(ens2, tmp_path):
    from repro_torch.serving.client import EnsembleClient
    cfgs, params = ens2
    s = make_system(cfgs, params, [[8, 0], [0, 8]])
    try:
        handles = [s.predict_async(_X(24, seed=i)) for i in range(3)]
        for h in handles:
            h.result(60.0)
        tr = s.tracer
        for h in handles:
            tl = tr.timeline(h.req.rid)
            names = {name for _tid, _ph, name, _t0, _dur in tl}
            # the connected admission -> combine view of one request
            assert {"submit", "pack", "dispatch_wait", "predict",
                    "transfer", "complete"} <= names
            assert "accumulate" in names or "combine" in names
            assert tl[0][2] == "submit"    # rooted at admission
            assert [e[3] for e in tl] == sorted(e[3] for e in tl)
        trace = json.loads(json.dumps(
            EnsembleClient(system=s).dump_trace(
                str(tmp_path / "trace.json"))))
        assert {ev["ph"] for ev in trace["traceEvents"]} <= {"M", "X", "i"}
        with open(tmp_path / "trace.json") as f:
            assert json.load(f) == trace
        # every completed request is attributed somewhere in the export
        for h in handles:
            rid = h.req.rid
            assert any(a.get("rid") == rid or rid in a.get("rids", ())
                       for a in (ev.get("args", {})
                                 for ev in trace["traceEvents"]))
    finally:
        s.shutdown()


def test_steal_and_quarantine_replay_instants(ens2):
    cfgs, params = ens2
    # two data-parallel instances of one member: quarantining one re-stripes
    # onto its sibling and annotates the admission track
    s = make_system(cfgs[:1], params[:1], [[8], [8]])
    try:
        hook = s._trace_queue_event("w9")
        req = types.SimpleNamespace(rid=5)
        hook("steal", [(req, 0), (req, 1)], 1)
        hook("enqueue", [(req, 2)], 0)     # covered by the submit span
        w = s.workers[0]
        s.quarantine_instance(w)
        h = s.predict_async(_X(16))        # sibling still serves
        h.result(60.0)
        events = s.tracer.tracks()["admission"]
        steal = [e for e in events if e[1] == "queue_steal"]
        assert len(steal) == 1
        assert steal[0][4] == (5,) and steal[0][5]["units"] == 2
        assert not any(e[1] == "queue_enqueue" for e in events)
        assert any(e[1] == "quarantine"
                   and e[5] == {"worker": w.worker_id} for e in events)
        assert any(e[1] == "quarantine_replay"
                   and e[5]["worker"] == w.worker_id for e in events)
    finally:
        s.shutdown()


def test_demote_and_cancel_instants(ens2):
    cfgs, params = ens2
    # slow fake devices keep requests in flight long enough to act on them
    s = make_system(cfgs, params, [[8, 0], [0, 8]], fake_delay_us=20000)
    try:
        h1 = s.predict_async(_X(64))
        assert s.demote_request(h1.req.rid, [0])
        h1.result(120.0)
        h2 = s.predict_async(_X(64))
        assert h2.cancel()
        with pytest.raises(RequestCancelled):
            h2.result(30.0)
        events = s.tracer.tracks()["admission"]
        demote = [e for e in events
                  if e[1] == "demote" and e[4] == h1.req.rid]
        assert demote and demote[0][5] == {"drop": [1], "kept": [0]}
        acc = s.tracer.tracks()["accumulator"]
        assert any(e[1] == "fail" and e[4] == h2.req.rid
                   and e[5] == {"error": "RequestCancelled"} for e in acc)
        assert any(e[1] == "complete" and e[4] == h1.req.rid for e in acc)
    finally:
        s.shutdown()


# ---- sim-vs-live comparability ----------------------------------------------

def test_sim_trace_spans_comparable_to_live():
    from repro_torch.serving.sim import (ServiceModel, SimSystem,
                                         WorkerSpec, poisson_trace)
    svc = ServiceModel.from_delays({0: 300, 1: 300})
    sim = SimSystem(svc, [WorkerSpec(0, 16), WorkerSpec(1, 16)],
                    segment_size=16, tracing=True)
    sim.run(poisson_trace(30, rate=200.0, seed=0))
    trace = sim.tracer.export()
    assert trace["metadata"]["clock"] == "virtual"
    # the sim emits the same stage names as the live pipeline, so a live
    # run and its replay produce directly comparable timelines
    assert {"submit", "pack", "dispatch_wait", "predict",
            "complete"} <= _names(trace)
    rid0 = trace["metadata"]["base_s"]     # rebased: first event at ts 0
    xs = [ev for ev in trace["traceEvents"] if ev["ph"] == "X"]
    assert min(ev["ts"] for ev in xs) == 0.0 and rid0 >= 0.0
    tl = sim.tracer.timeline(0)
    assert {name for _t, _p, name, _a, _b in tl} >= \
        {"submit", "dispatch_wait", "predict", "complete"}


# ---- metrics: Prometheus exposition + histograms ----------------------------

def test_prometheus_text_families():
    t = StageTimers()
    t.inc("batches", 3)
    t.add("predict", 0.5)
    t.gauge("queue_depth.w0", 4)
    t.gauge("health.w0", 0)
    t.gauge("hp_p50_ms", 2.5)
    text = prometheus_text(t, extra_gauges={"in_flight": 2})
    assert "# TYPE serving_batches_total counter" in text
    assert "serving_batches_total 3" in text
    assert 'serving_stage_seconds_total{stage="predict"} 0.5' in text
    assert 'serving_stage_operations_total{stage="predict"} 1' in text
    assert 'serving_queue_depth{worker="w0"} 4' in text
    assert 'serving_worker_health{worker="w0"} 0' in text
    assert "serving_hp_p50_ms 2.5" in text
    assert "serving_in_flight 2" in text
    assert text.endswith("\n")


def test_prometheus_latency_histogram_cumulative():
    t = StageTimers()
    for _ in range(10):
        t.latency("normal", 0.001)
    for _ in range(10):
        t.latency("normal", 0.1)
    t.latency("normal", 1e9)               # overflow bucket
    text = prometheus_text(t)
    buckets = [ln for ln in text.splitlines()
               if ln.startswith('serving_request_latency_seconds_bucket'
                                '{class="normal"')]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert counts == sorted(counts)        # cumulative
    assert buckets[-1].startswith(
        'serving_request_latency_seconds_bucket{class="normal",le="+Inf"}')
    assert counts[-1] == 21
    assert 'serving_request_latency_seconds_count{class="normal"} 21' in text
    assert len(buckets) == len(LATENCY_BOUNDS_S) + 1


def test_latency_snapshot_histogram_accuracy():
    t = StageTimers()
    for _ in range(99):
        t.latency("high", 0.010)
    t.latency("high", 1.0)
    snap = t.latency_snapshot()
    assert set(snap) == {"high"}
    assert set(snap["high"]) == {"n", "p50_ms", "p99_ms"}
    assert snap["high"]["n"] == 100
    # log buckets at sqrt(2) resolution: estimates land within one bucket
    assert 10 / 2 ** 0.5 <= snap["high"]["p50_ms"] <= 10 * 2 ** 0.5
    assert 1000 / 2 ** 0.5 <= snap["high"]["p99_ms"] <= 1000 * 2 ** 0.5
    # the hp_p50 gauge tracks the histogram median
    assert t.gauge_snapshot()["hp_p50_ms"]["last"] == \
        pytest.approx(snap["high"]["p50_ms"])


def test_gauge_snapshot_races_first_time_inserts():
    # regression: snapshot iterating the gauge dict while workers insert
    # new queue_depth.<id> keys must not blow up mid-resize
    t = StageTimers()
    stop = threading.Event()
    errors = []

    def writer(k):
        i = 0
        while not stop.is_set():
            t.gauge(f"queue_depth.w{k}_{i}", float(i))
            i += 1

    def reader():
        try:
            while not stop.is_set():
                for name, g in t.gauge_snapshot().items():
                    assert g["last"] >= 0.0
        except Exception as e:             # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(3)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for th in threads:
        th.start()
    th = threading.Timer(0.5, stop.set)
    th.start()
    stop.wait(5.0)
    for th_ in threads:
        th_.join(5.0)
    assert not errors


def test_sim_trace_export_equals_jax():
    """On the virtual clock the simulator's trace export is the JAX
    package's, event for event."""
    from repro.serving import sim as jsim
    from repro_torch.serving import sim as tsim
    exports = []
    for sim_mod in (jsim, tsim):
        sim = sim_mod.SimSystem(
            sim_mod.ServiceModel.from_delays({0: 300, 1: 300}),
            [sim_mod.WorkerSpec(0, 16), sim_mod.WorkerSpec(1, 16)],
            segment_size=16, tracing=True)
        sim.run(sim_mod.poisson_trace(30, rate=200.0, seed=0))
        exports.append(json.dumps(sim.tracer.export(), sort_keys=True))
    assert exports[0] == exports[1]


# ---- the serving path's own waits and device timing ------------------------

def _stall_sender(w):
    """Hold ``w``'s sender before each chunk until the returned event is
    set: its ring slots stay in flight, so its batcher waits for one."""
    gate = threading.Event()
    send = w._send_chunk

    def stalled(*a, **k):
        gate.wait(30.0)
        return send(*a, **k)
    w._send_chunk = stalled
    return gate


def test_slot_wait_takes_the_ring_wait_out_of_batch_fill(ens2):
    cfgs, params = ens2
    # one member, batch 8, segment 16: a slot holds one segment, so a
    # 128-row request needs twice the four ring slots
    s = make_system(cfgs[:1], params[:1], [[8]], segment_size=16)
    try:
        s.predict_async(_X(16)).result(60.0)   # every stage warm
        s.timers.reset()
        gate = _stall_sender(s.workers[0])
        h = s.predict_async(_X(128))
        time.sleep(0.4)
        gate.set()
        h.result(60.0)
        st = s.stage_timings()
        assert st["slot_wait"]["total_s"] >= 0.3
        assert st["batch_fill"]["count"] == 8      # one per descriptor
        assert st["batch_fill"]["total_s"] < 0.25 * st["slot_wait"]["total_s"]
        assert st["input_wait"]["count"] == 8
    finally:
        s.shutdown()


def test_admission_wait_covers_the_in_flight_window(ens2):
    cfgs, params = ens2
    s = make_system(cfgs[:1], params[:1], [[8]], max_in_flight=1)
    try:
        gate = _stall_sender(s.workers[0])
        held = s.predict_async(_X(8))          # takes the only window slot
        s.timers.reset()
        out = []
        th = threading.Thread(target=lambda: out.append(
            s.predict_async(_X(8, seed=1))))
        t0 = time.perf_counter()
        th.start()
        time.sleep(0.4)
        gate.set()
        held.result(60.0)
        th.join(60.0)
        assert not th.is_alive()
        out[0].result(60.0)
        st = s.stage_timings()["admission_wait"]
        assert st["count"] == 1 and st["total_s"] >= 0.35
        # the request's timeline is rooted where its caller asked
        submit = [e for e in s.tracer.tracks()["admission"]
                  if e[1] == "submit" and e[4] == out[0].req.rid]
        assert len(submit) == 1
        assert t0 <= submit[0][2] < t0 + 0.2 and submit[0][3] >= 0.35
        assert s.tracer.timeline(out[0].req.rid)[0][2] == "submit"
    finally:
        s.shutdown()


def test_combine_and_post_once_per_fold_and_partial(ens2):
    cfgs, params = ens2
    # two members on one device: one partial per segment, two folds into it
    s = make_system(cfgs, params, [[8, 8]], segment_size=16)
    try:
        (comb,) = s.combiners.values()
        folds = []
        fold = comb._fold

        def counted(*a, **k):
            folds.append(1)
            return fold(*a, **k)
        comb._fold = counted
        s.timers.reset()
        s.predict(_X(40))                      # 3 segments x 2 members
        st = s.stage_timings()
        assert len(folds) == 6 and st["combine"]["count"] == 6
        assert comb.partials_posted == 3 and st["post"]["count"] == 3
        posts = [e for e in s.tracer.tracks()[f"combine.{comb.name}"]
                 if e[1] == "post"]
        assert sorted(e[5]["s"] for e in posts) == [0, 1, 2]
        assert all(e[5]["count"] == 2 for e in posts)
    finally:
        s.shutdown()


@pytest.mark.parametrize("tracing", [False, True])
def test_forward_device_time_only_while_tracing(ens2, tracing):
    cfgs, params = ens2
    # real forwards on the CPU (no fake devices): batches of 8 and 16.  The
    # device timing is the card's alone (tests/test_torch_cuda.py): on the
    # CPU a forward runs inside its own enqueue, so nothing is recorded,
    # traced or not; the descriptors' input wait is recorded while tracing
    s = make_system(cfgs, params, [[8, 16]], segment_size=16, fake=False,
                    tracing=tracing)
    try:
        s.timers.reset()
        s.predict(_X(40))
        stages, counters = s.stage_timings(), s.serving_counters()
        tracks = s.tracer.tracks()
        assert not [k for k in stages
                    if k.startswith(("forward_device", "device_queue"))]
        assert not any(k.startswith("forward_rows") for k in counters)
        assert not any(t.endswith("/device") for t in tracks)
        assert stages["transfer"]["count"] > 0      # the forwards did run
        if tracing:
            assert stages["input_wait"]["count"] == 2 * 3   # members x segs
        else:
            assert "input_wait" not in stages
    finally:
        s.shutdown()


def test_device_track_exports_forward_spans_joined_through_t_enq():
    tr = Tracer(enabled=True, capacity=64)
    tr.ring("w0/batcher").append(("i", "pack", 10.0, 0.0, 1, 1, 0, None))
    tr.ring("w0/batcher").append(("i", "pack", 11.0, 0.0, (2, 3), 1, 0, None))
    for t_enq, t0 in ((10.0, 12.0), (11.0, 12.5)):
        tr.ring("w0/device").append(
            ("g", "forward", t0, 0.4, None, pack_times((t_enq,)), 1,
             pack_times((t0 - 0.5, t0 + 0.45))))
    (_ph, name, t0, dur, rid, args), _ = tr.tracks()["w0/device"]
    assert (name, t0, dur, rid) == ("forward", 12.0, 0.4, None)
    assert args == {"t_enq": (10.0,), "chunks": 1, "enqueued": 11.5,
                    "synced": 12.45}
    fwd = sorted((ev for ev in tr.export()["traceEvents"]
                  if ev.get("name") == "forward"), key=lambda e: e["ts"])
    assert [ev["ph"] for ev in fwd] == ["X", "X"]
    assert fwd[0]["args"] == {"rid": 1, "chunks": 1}
    assert fwd[1]["args"] == {"rids": [2, 3], "chunks": 1}
    assert fwd[0]["ts"] == pytest.approx(2e6)      # rebased to the pack
    assert fwd[1]["dur"] == pytest.approx(0.4e6)
    assert ("w0/device", "X", "forward", 12.5, 0.4) in tr.timeline(3)
    assert not any(e[2] == "forward" and e[3] == 12.5
                   for e in tr.timeline(1))
