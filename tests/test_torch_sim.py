"""The PyTorch port's discrete-event simulator, ported from tests/test_sim.py
(DESIGN.md §12): event-loop determinism, generator reproducibility,
bit-identical same-seed runs, priority isolation and device contention
in-sim, the real control plane (stealing / brownout / EDF / K-tuner) driven
under the virtual clock, the LiveBench forecast-vs-EWMA handoff; plus the
same traces through the JAX package's simulator giving equal results and
event logs, with no tolerance.  The trace schema and the live recorder hook
are in tests/test_torch_trace.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import sim as jsim  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.serving import sim as tsim  # noqa: E402
from repro_torch.serving.admission import EDFDispatchQueue  # noqa: E402
from repro_torch.serving.control import BrownoutController, LiveBench  # noqa: E402
from repro_torch.serving.sim import (DemandForecaster, EventLoop,  # noqa: E402
                                     ServiceModel, SimSystem, WorkerSpec,
                                     diurnal_trace, mmpp_trace,
                                     poisson_trace, tune_dispatch_ahead)
from repro_torch.serving.trace import TraceEvent  # noqa: E402

SEQ = 16


# ---- event loop --------------------------------------------------------------

def test_event_loop_equal_timestamps_fire_in_schedule_order():
    loop = EventLoop()
    fired = []
    loop.schedule(1.0, fired.append, "a")
    loop.schedule(1.0, fired.append, "b")
    loop.schedule(0.5, fired.append, "c")
    loop.schedule(0.0, fired.append, "d")   # in the past once now advances
    loop.run()
    assert fired == ["d", "c", "a", "b"]
    assert loop.now == 1.0
    loop.schedule(0.2, fired.append, "late")   # clamped to now, not dropped
    loop.run()
    assert fired[-1] == "late" and loop.now == 1.0


# ---- trace generators -------------------------------------------------------

def test_generators_deterministic_and_sorted():
    for gen in (lambda s: poisson_trace(200, rate=100.0, seed=s,
                                        high_fraction=0.3,
                                        members_choices=[(0,), (1,)]),
                lambda s: mmpp_trace(200, seed=s, calm_rate=50.0,
                                     burst_rate=500.0),
                lambda s: diurnal_trace(200, seed=s, rate=100.0,
                                        period_s=1.0)):
        a, b, c = gen(3), gen(3), gen(4)
        assert a == b
        assert a != c
        ts = [e.t for e in a]
        assert ts == sorted(ts)
    tr = diurnal_trace(500, seed=0, rate=1000.0, period_s=0.1)
    assert {e.members for e in tr} == {(0,), (1,)}   # both groups drawn


# ---- core engine -------------------------------------------------------------

def _bulk_sim(**kw):
    svc = kw.pop("svc", ServiceModel.from_delays({0: 500, 1: 500}))
    specs = kw.pop("specs", [WorkerSpec(0, 16), WorkerSpec(1, 16)])
    return SimSystem(svc, specs, segment_size=16, **kw)


def test_sim_underload_completes_everything():
    trace = poisson_trace(500, rate=200.0, seed=1, rows=8,
                          members_choices=[(0,), (1,), (0, 1)])
    sim = _bulk_sim().run(trace)
    r = sim.results()
    assert r["offered"] == 500 and r["completed"] == 500
    assert r["failed"] == 0 and sim.open_requests == 0
    assert 0.0 < r["p99_ms"] and r["throughput_req_per_s"] > 0


def test_sim_determinism_bit_identical():
    trace = mmpp_trace(2000, seed=5, calm_rate=500.0, burst_rate=8000.0,
                       rows=(1, 8, 24), high_fraction=0.2,
                       members_choices=[(0,), (1,), (0, 1)])
    runs = []
    for _ in range(2):
        sim = _bulk_sim(record_events=True).run(trace)
        runs.append((tuple(sim.event_log), sim.results()))
    assert runs[0][0] == runs[1][0]          # bit-identical event log
    assert runs[0][1] == runs[1][1]          # and metrics
    assert len(runs[0][0]) > 0


def test_sim_priority_isolation_under_backlog():
    svc = ServiceModel.from_delays({0: 2000})
    trace = poisson_trace(400, rate=1200.0, seed=2, rows=8,
                          high_fraction=0.15, members_choices=[(0,)])
    sim = SimSystem(svc, [WorkerSpec(0, 8)], segment_size=16,
                    dispatch_ahead=1).run(trace)
    r = sim.results()
    assert r["completed"] == 400
    # saturated bulk backlog: the express path keeps high-priority latency
    # well under the queue-bound normal class
    assert r["hp_p50_ms"] < r["np_p50_ms"] / 2


def test_sim_colocated_workers_time_share_their_device():
    svc = ServiceModel.from_delays({0: 1000, 1: 1000})
    trace = poisson_trace(300, rate=1e6, seed=3, rows=16,
                          members_choices=[(0,), (1,)])

    def makespan(keys):
        sim = SimSystem(svc, [WorkerSpec(0, 16, device_key=keys[0]),
                              WorkerSpec(1, 16, device_key=keys[1])],
                        segment_size=16).run(trace)
        return sim.results()["makespan_s"]

    apart = makespan(("devA", "devB"))
    shared = makespan(("devA", "devA"))   # must serialize: ~2x the makespan
    assert shared > 1.8 * apart


def test_sim_balancer_steals_from_slow_sibling():
    svc = ServiceModel.from_delays({0: 2000})
    trace = poisson_trace(300, rate=2000.0, seed=4, rows=16,
                          members_choices=[(0,)])
    sim = SimSystem(svc, [WorkerSpec(0, 16, speed=1.0),
                          WorkerSpec(0, 16, speed=0.05)], segment_size=16)
    sim.attach_balancer(0.002, threshold=4)
    sim.run(trace)
    r = sim.results()
    assert r["completed"] == 300
    assert sim.timers.counters.get("steals", 0) >= 1


def test_sim_brownout_sheds_infeasible_deadlines():
    svc = ServiceModel.from_delays({0: 5000})
    trace = poisson_trace(1500, rate=10_000.0, seed=6, rows=64,
                          deadline_ms=50.0, members_choices=[(0,)])
    sim = SimSystem(svc, [WorkerSpec(0, 64)], segment_size=64)
    ctrl = BrownoutController(sim, deadline_budget_ms=50.0)   # no .start()
    sim.add_control(ctrl.interval_s, lambda s: ctrl.step())
    sim.run(trace)
    r = sim.results()
    assert r["shed"] > 0                       # cost-aware admission engaged
    # every offered request resolves: served, typed-shed, or expired-dropped
    assert r["completed"] + r["shed"] + r["failed"] == r["offered"]
    assert r["completed"] > 0


def test_sim_edf_clears_deadlines_fifo_misses():
    svc = ServiceModel.from_delays({0: 2000})
    events = []
    for b in range(10):
        t = b * 0.012
        for i in range(4):
            events.append(TraceEvent(t=t + i * 1e-5, rows=64,
                                     deadline_ms=7.0 if i >= 2 else 400.0,
                                     members=(0,)))
    misses = {}
    for name, kw in (("fifo", {}), ("edf", {"queue_cls": EDFDispatchQueue})):
        sim = SimSystem(svc, [WorkerSpec(0, 64)], segment_size=64,
                        dispatch_ahead=1, max_wait_us=100, **kw)
        sim.run(events)
        misses[name] = sim.results()["deadline_misses"]
    assert misses["fifo"] > 0
    assert misses["edf"] == 0


def test_tuner_reproduces_dispatch_ahead_default():
    svc = ServiceModel.from_delays({0: 1000}, dispatch_overhead_s=2e-4)
    trace = poisson_trace(200, rate=1e6, seed=13, rows=64,
                          members_choices=[(0,)])
    out = tune_dispatch_ahead(
        lambda k: SimSystem(svc, [WorkerSpec(0, 8)], segment_size=64,
                            dispatch_ahead=k, max_wait_us=100),
        trace, ks=(1, 4, 16, 32))
    assert out["recommended"] == 16
    thr = {k: v["throughput_rows_per_s"] for k, v in out["per_k"].items()}
    assert thr[16] > thr[1]                    # overhead amortization is real


# ---- service model -----------------------------------------------------------

def test_service_model_fit_paths():
    flat = ServiceModel.from_delays({0: 1000})
    assert flat.chunk_time(0, 8) == pytest.approx(1e-3)
    assert flat.chunk_time(0, 64) == pytest.approx(1e-3)   # bucket-flat
    snap = {"latency_ewma_s": {"m0|cpu:0|b16": 0.002, "m0|cpu:1|b16": 0.004,
                               "m1|cpu:0|b8": 0.001}}
    fit = ServiceModel.from_livebench(snap)
    assert fit.chunk_time(0, 16) == pytest.approx(0.003)   # device-averaged
    assert fit.chunk_time(0, 32) == pytest.approx(0.006)   # row-scaled
    assert fit.members() == (0, 1)
    with pytest.raises(ValueError):
        ServiceModel.from_livebench({"latency_ewma_s": {}})


# ---- forecasting -------------------------------------------------------------

def test_forecaster_extrapolates_linear_trend():
    fc = DemandForecaster(2, bin_s=0.1, trend_bins=4)
    # member 0's share climbs 0.2 -> 0.5 over closed bins; the trend must
    # put the lead-horizon prediction above the last observed share
    for i, share in enumerate((0.2, 0.3, 0.4, 0.5)):
        for _ in range(int(share * 100)):
            fc.observe(i * 0.1, [0], 1)
        for _ in range(int((1 - share) * 100)):
            fc.observe(i * 0.1, [1], 1)
    fc.observe(0.4, [0], 1)                    # close the last bin
    pred = fc.predict_shares(lead_s=0.2)
    assert pred[0] > 0.55
    assert pred.sum() == pytest.approx(1.0)
    cold = DemandForecaster(3, bin_s=0.1)
    assert cold.predict_shares(0.1) == pytest.approx(np.full(3, 1 / 3))


def test_livebench_forecast_fresh_then_stale_handoff():
    cfgs = ensemble("ENS4")[:2]
    live = LiveBench(cfgs, seq=SEQ)
    t = [0.0]
    live.clock = lambda: t[0]                  # virtual time, as in-sim
    for _ in range(50):
        live.note_request([0], 8)              # EWMA: all demand on m0
    fc = DemandForecaster(2, bin_s=0.1, trend_bins=2)
    for i in range(3):                         # forecaster: all demand on m1
        fc.observe(i * 0.1, [1], 8)
    fc.feed(live, lead_s=0.1, ttl_s=0.5)
    assert live.forecast_fresh()
    assert live.demand_shares()[1] > 0.9       # fresh: forecast wins
    t[0] += 1.0                                # TTL expires on virtual clock
    assert not live.forecast_fresh()
    assert live.demand_shares()[0] > 0.9       # stale: EWMA fallback


# ---- against the JAX package ---------------------------------------------------

_TRACES = {
    "poisson": lambda m: m.poisson_trace(
        500, rate=200.0, seed=1, rows=8, high_fraction=0.2,
        members_choices=[(0,), (1,), (0, 1)]),
    "mmpp": lambda m: m.mmpp_trace(
        2000, seed=5, calm_rate=500.0, burst_rate=8000.0, rows=(1, 8, 24),
        high_fraction=0.2, members_choices=[(0,), (1,), (0, 1)]),
}


@pytest.mark.parametrize("trace", sorted(_TRACES))
def test_sim_equals_the_jax_package(trace):
    """The same generator call, the same ``ServiceModel.from_delays`` and
    allocation: equal traces, ``results()`` and event logs in both
    packages (no float is computed differently)."""
    out = []
    for m in (jsim, tsim):
        tr = _TRACES[trace](m)
        sim = m.SimSystem(m.ServiceModel.from_delays({0: 500, 1: 900}),
                          [m.WorkerSpec(0, 16), m.WorkerSpec(1, 8),
                           m.WorkerSpec(0, 16, device_key="d1")],
                          segment_size=16, record_events=True).run(tr)
        out.append(([(e.t, e.rows, e.priority, e.deadline_ms, e.members)
                     for e in tr], sim.results(), sim.event_log))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert out[0][2] == out[1][2] and len(out[0][2]) > 0
