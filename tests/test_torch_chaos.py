"""The chaos suite against the PyTorch port, ported from tests/test_chaos.py,
plus a fault plan's parity with the JAX package.

Chaos suite (DESIGN.md §10): deterministic fault injection against the
supervision / quarantine / replay / degradation machinery.

Every test runs on simulated (``fake``) or host-CPU devices with a
:class:`FaultPlan` arming exactly one failure, so each recovery path is
exercised at a reproducible pipeline position:

  * killing one data-parallel sibling mid-trace loses zero requests, and
    replayed chunks produce **bit-identical** results vs a fault-free run;
  * killing a member's only instance completes open requests with a
    degraded-quality partial combine — never a hang, never the global
    shutdown — and the controller respawns the member in background;
  * the global {-1, None, None} sentinel fires only for the last instance
    of the last member;
  * stalls are caught by the watchdog, spawn failures back off, retry
    budgets bound replay, NaN outputs crash their worker instead of
    folding into Y.
"""
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core.allocation import AllocationMatrix  # noqa: E402
from repro_torch.core.devices import host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.control import ReconfigController  # noqa: E402
from repro_torch.serving.faults import (FaultPlan, FaultSpec,  # noqa: E402
                                        InjectedFault)
from repro_torch.serving.segments import (MemberUnavailable,  # noqa: E402
                                          RetriesExhausted)
from repro_torch.serving.system import InferenceSystem  # noqa: E402
from repro_torch.serving.worker import HEALTH_DEAD, HEALTH_READY  # noqa: E402

pytestmark = pytest.mark.chaos

SEQ = 16


@functools.lru_cache(maxsize=None)
def _jax_ens2():
    """The JAX package's first two ENS4 members and their parameters."""
    cfgs = jensemble("ENS4")[:2]
    rng = jax.random.PRNGKey(0)
    return cfgs, [M.init_params(jax.random.fold_in(rng, i), c)
                  for i, c in enumerate(cfgs)]


@pytest.fixture(scope="module")
def ens2():
    """The port's ENS4[:2] on the JAX package's parameters, bridged."""
    return ensemble("ENS4")[:2], [
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
        for p in _jax_ens2()[1]]


def oracle(cfgs, X, weights=None):
    """The JAX package's forwards of the members named by ``cfgs`` on the
    same parameters, combined in numpy (tests/test_serving.py's oracle)."""
    jax_members = dict((c.name, (c, p)) for c, p in zip(*_jax_ens2()))
    w = weights if weights is not None else [1 / len(cfgs)] * len(cfgs)
    out = np.zeros((X.shape[0], cfgs[0].vocab_size), np.float32)
    for i, c in enumerate(cfgs):
        jc, p = jax_members[c.name]
        lg, _ = M.forward(p, jc, jnp.asarray(X))
        out += np.asarray(lg[:, -1, :jc.vocab_size]) * w[i]
    return out


def make_system(cfgs, params, A, **kw):
    A = np.array(A)
    devs = host_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs], A)
    kw.setdefault("max_seq", SEQ)
    kw.setdefault("supervise", True)
    kw.setdefault("supervise_interval_s", 0.02)
    return InferenceSystem(cfgs, params, alloc, **kw)


def _X(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 64, (n, SEQ)).astype(np.int32)


# ---- FaultPlan mechanics -----------------------------------------------------

def test_fault_spec_parse_and_validation():
    s = FaultSpec.parse("stage=predictor,kind=stall,after=3,stall_s=1.5,"
                        "worker=w0.0")
    assert (s.stage, s.kind, s.after, s.stall_s, s.worker) == \
        ("predictor", "stall", 3, 1.5, "w0.0")
    with pytest.raises(ValueError):
        FaultSpec.parse("kind=raise")             # stage required
    with pytest.raises(ValueError):
        FaultSpec.parse("stage=predictor,bogus=1")
    with pytest.raises(ValueError):
        FaultSpec(stage="sender", kind="nan")     # nan is predictor-only
    with pytest.raises(ValueError):
        FaultSpec(stage="nope")


def test_fault_plan_counts_and_fires_once():
    fp = FaultPlan(FaultSpec(stage="sender", after=2, worker="w0"))
    assert fp.tick("w1", "sender") is None        # wrong worker prefix
    assert fp.tick("w0", "sender") is None        # unit 0
    assert fp.tick("w0", "sender") is None        # unit 1
    with pytest.raises(InjectedFault):
        fp.tick("w0", "sender")                   # unit 2 fires
    assert fp.tick("w0", "sender") is None        # one-shot: never again
    assert fp.fired == [("w0", "sender", "raise")]


# ---- zero-loss sibling recovery ----------------------------------------------

@pytest.mark.parametrize("stage", ["batcher", "predictor", "sender"])
def test_sibling_kill_loses_zero_requests(ens2, stage):
    """Killing one of two data-parallel siblings mid-trace: every request
    completes at full quality, via replay on the surviving sibling."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage=stage, kind="raise", after=1,
                             worker="w1.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=300, fault_plan=fp)
    try:
        hs = [s.predict_async(_X(48, seed=i)) for i in range(10)]
        Ys = [h.result(60.0) for h in hs]
        assert all(y.shape == (48, cfgs[0].vocab_size) for y in Ys)
        assert all(h.quality == 1.0 for h in hs)
        c = s.serving_counters()
        assert c.get("quarantines") == 1
        assert c.get("worker_crashes") == 1
        # the dead sibling left routing; member 0 still has w0.0
        assert [w.worker_id for w in s.instances(0)] == ["w0.0"]
        # and the system still serves new requests
        assert s.predict(_X(16), timeout=60.0).shape[0] == 16
    finally:
        s.shutdown()


def test_sibling_kill_bit_identical_replay(ens2):
    """Replayed chunks re-run the same compiled fn at the same batch shape
    on identical rows — results match a fault-free run bit for bit."""
    cfgs, params = ens2
    A = [[8, 8], [8, 0]]                  # m0: siblings w0.0/w1.0, equal b=8
    Xs = [_X(8, seed=i) for i in range(8)]

    def run(fault_plan):
        # generous watchdog: real-model compiles under CPU contention must
        # not read as stalls and quarantine a healthy worker
        s = make_system(cfgs, params, A, segment_size=8, watchdog_s=60.0,
                        fault_plan=fault_plan)
        try:
            hs = [s.predict_async(x) for x in Xs]
            return [np.array(h.result(120.0)) for h in hs], \
                [h.quality for h in hs]
        finally:
            s.shutdown()

    base, _ = run(None)
    fp = FaultPlan(FaultSpec(stage="predictor", kind="raise", after=1,
                             worker="w1.0"))
    faulted, quals = run(fp)
    assert all(q == 1.0 for q in quals)
    for i, (yb, yf) in enumerate(zip(base, faulted)):
        np.testing.assert_array_equal(yb, yf, err_msg=f"request {i}")


def test_faulted_replay_matches_the_jax_package(ens2):
    """The same fault plan in both packages: the port's replayed Y equals
    its own unfaulted Y exactly, the JAX package's faulted Y within
    tests/test_serving.py's atol, and both agree with the oracle."""
    from repro.core import AllocationMatrix as JAllocationMatrix
    from repro.core import host_cpus as jhost_cpus
    from repro.serving.faults import FaultPlan as JFaultPlan
    from repro.serving.faults import FaultSpec as JFaultSpec
    from repro.serving.system import InferenceSystem as JInferenceSystem
    cfgs, params = ens2
    jcfgs, jparams = _jax_ens2()
    A = np.array([[8, 8], [8, 0]])
    Xs = [_X(8, seed=i) for i in range(8)]
    kw = dict(segment_size=8, watchdog_s=60.0, max_seq=SEQ, supervise=True,
              supervise_interval_s=0.02)

    def run(s):
        try:
            hs = [s.predict_async(x) for x in Xs]
            Ys = [np.array(h.result(120.0)) for h in hs]
            assert all(h.quality == 1.0 for h in hs)
            return Ys, s.serving_counters()
        finally:
            s.shutdown()

    spec = dict(stage="predictor", kind="raise", after=1, worker="w1.0")
    base, _ = run(make_system(cfgs, params, A, segment_size=8,
                              watchdog_s=60.0))
    port, c = run(make_system(cfgs, params, A, segment_size=8,
                              watchdog_s=60.0,
                              fault_plan=FaultPlan(FaultSpec(**spec))))
    assert c.get("quarantines") == 1 and c.get("segments_replayed") >= 1
    jalloc = JAllocationMatrix(jhost_cpus(2, 8 * 1024 ** 3),
                               [c.name for c in jcfgs], A)
    ref, jc = run(JInferenceSystem(jcfgs, jparams, jalloc,
                                   fault_plan=JFaultPlan(JFaultSpec(**spec)),
                                   **kw))
    assert jc.get("quarantines") == 1
    for i, (yb, yp, yj, x) in enumerate(zip(base, port, ref, Xs)):
        np.testing.assert_array_equal(yp, yb, err_msg=f"request {i}")
        np.testing.assert_allclose(yp, yj, atol=2e-5, err_msg=f"request {i}")
        np.testing.assert_allclose(yp, oracle(cfgs, x), atol=2e-5)


def test_stall_detected_and_quarantined(ens2):
    """A stage stuck mid-work past the watchdog is DEGRADED -> quarantined;
    the stalled thread's late wakeup is gated by the ledger pop (no
    double-posts, so every request still completes exactly once)."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="predictor", kind="stall", after=1,
                             stall_s=2.0, worker="w1.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=300, fault_plan=fp, watchdog_s=0.2)
    try:
        hs = [s.predict_async(_X(48, seed=i)) for i in range(10)]
        Ys = [h.result(60.0) for h in hs]
        assert all(y.shape[0] == 48 for y in Ys)
        c = s.serving_counters()
        assert c.get("stalls_detected") >= 1
        assert c.get("quarantines") == 1
        time.sleep(2.2)                   # let the stalled thread wake up
        assert s.predict(_X(16), timeout=60.0).shape[0] == 16
    finally:
        s.shutdown()


def test_nan_guard_recovers_on_sibling(ens2):
    """An injected NaN output crashes its worker (WorkerCrashed through the
    guard) and the chunk replays cleanly on the sibling."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="predictor", kind="nan", after=0,
                             worker="w1.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=300, fault_plan=fp, nan_guard=True)
    try:
        hs = [s.predict_async(_X(48, seed=i)) for i in range(8)]
        for h in hs:
            assert not np.isnan(h.result(60.0)).any()
        c = s.serving_counters()
        assert c.get("worker_crashes") == 1 and c.get("quarantines") == 1
    finally:
        s.shutdown()


def test_retry_budget_exhaustion(ens2):
    """With retry_budget=0, the first quarantine that touches a request's
    in-flight work fails it with RetriesExhausted instead of replaying."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="predictor", kind="raise", after=0,
                             worker="w1.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=2000, fault_plan=fp, retry_budget=0)
    try:
        hs = [s.predict_async(_X(48, seed=i)) for i in range(8)]
        outcomes = set()
        for h in hs:
            try:
                h.result(60.0)
                outcomes.add("ok")
            except RetriesExhausted:
                outcomes.add("exhausted")
        assert "exhausted" in outcomes    # at least the in-flight ones
    finally:
        s.shutdown()


# ---- graceful degradation ----------------------------------------------------

def test_sole_instance_death_degrades_not_hangs(ens2):
    """Killing a member's ONLY instance completes open requests with a
    partial-ensemble combine (quality < 1, renormalized over survivors) —
    never a hang, never a global shutdown."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="batcher", kind="raise", after=1,
                             worker="w0.1"))    # m1's sole instance
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=500, fault_plan=fp)
    try:
        hs = []
        for i in range(8):
            try:
                hs.append(s.predict_async(_X(48, seed=i)))
            except MemberUnavailable:
                break                     # crash landed mid-loop: fail-fast
        assert hs                         # at least one request got in
        Ys = [h.result(60.0) for h in hs]     # nothing hangs
        assert all(y.shape[0] == 48 for y in Ys)
        quals = [h.quality for h in hs]
        assert any(q < 1.0 for q in quals)    # open requests degraded
        assert all(0.0 < q <= 1.0 for q in quals)
        c = s.serving_counters()
        assert c.get("degraded_requests") >= 1
        # new full-ensemble submits fail fast with the retryable error...
        with pytest.raises(MemberUnavailable):
            s.predict(_X(8), timeout=10.0)
        # ...but the surviving member still serves
        assert s.predict(_X(16), timeout=60.0,
                         members=[0]).shape[0] == 16
    finally:
        s.shutdown()


def test_degraded_renormalization_weights(ens2):
    """Degraded rows renormalize over surviving members: with fake workers
    member predictions are all-zeros, so Y is zero either way — instead
    verify quality accounting matches the lost fraction exactly."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="batcher", kind="raise", after=0,
                             worker="w0.1"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=500, fault_plan=fp)
    try:
        h = s.predict_async(_X(48))
        h.result(60.0)
        if h.quality < 1.0:               # the open request lost member 1
            assert h.quality == pytest.approx(0.5)
    finally:
        s.shutdown()


def test_member_respawn_in_background(ens2):
    """After a sole-instance death the controller respawns the member with
    backoff; full-ensemble serving resumes."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="batcher", kind="raise", after=0,
                             worker="w0.1"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=300, fault_plan=fp)
    ctl = ReconfigController(s, replan=False, steal=True).start()
    try:
        try:
            s.predict(_X(32), timeout=30.0)
        except MemberUnavailable:
            pass
        deadline = time.perf_counter() + 15.0
        while not s.instances(1) and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert s.instances(1), "member 1 was not respawned"
        assert s.predict(_X(32), timeout=60.0).shape[0] == 32
        assert ctl.stats()["counters"]["respawns"] == 1
    finally:
        ctl.stop()
        s.shutdown()


def test_last_member_last_instance_fires_global_sentinel(ens2):
    """With ONE member on ONE instance, its death leaves nothing to degrade
    onto: the paper's global {-1, None, None} semantics apply."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="batcher", kind="raise", after=0))
    s = make_system(cfgs[:1], params[:1], [[8]], fake=True,
                    fake_delay_us=500, fault_plan=fp)
    try:
        h = s.predict_async(_X(48))
        with pytest.raises(MemoryError):
            h.result(30.0)
    finally:
        s.shutdown()


# ---- supervision plumbing ----------------------------------------------------

def test_spawn_fault_and_controller_backoff(ens2):
    """A failed speculative spawn counts, backs off exponentially, and is
    not re-attempted until the backoff expires."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="spawn", kind="raise", worker="w1.1"))
    s = make_system(cfgs, params, [[8, 8], [0, 0]], fake=True,
                    supervise=False, fault_plan=fp)
    ctl = ReconfigController(s, replan=False, steal=False)
    try:
        gen = s.generation + 1
        assert ctl._spawn(1, 1, 8, gen) is False      # injected spawn fault
        assert ctl.counters["spawn_failures"] == 1
        # the spec is one-shot, so a retry would succeed — but the backoff
        # must skip it without attempting
        assert ctl._spawn(1, 1, 8, gen) is False
        assert ctl.counters["spawn_failures"] == 1    # skipped, not failed
        ctl._backoff[(1, 1)][1] = 0.0                 # force-expire backoff
        assert ctl._spawn(1, 1, 8, gen) is True
        assert (1, 1) not in ctl._backoff             # success clears it
    finally:
        s.shutdown()


def test_join_reports_stuck_threads(ens2):
    """Worker.join must name the stage threads that failed to stop instead
    of silently returning."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="predictor", kind="stall", after=0,
                             stall_s=2.5, worker="w0.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=100, fault_plan=fp, watchdog_s=0.2)
    try:
        stalled = next(w for w in s.workers if w.worker_id == "w0.0")
        s.predict_async(_X(16))
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            if s.serving_counters().get("quarantines"):
                break
            time.sleep(0.05)
        live_ids = {w.worker_id for w in s.workers}
        assert "w0.0" not in live_ids     # quarantined out of routing
        # the predictor is asleep inside the injected stall: a bounded join
        # must come back and say so, not hang or lie
        stuck = stalled.join(timeout=0.2)
        assert any("predictor" in name for name in stuck)
        assert s.serving_counters().get("join_timeouts") >= 1
    finally:
        s.shutdown()


def test_health_gauges_exported(ens2):
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="predictor", kind="raise", after=0,
                             worker="w1.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=300, fault_plan=fp)
    try:
        hs = [s.predict_async(_X(48, seed=i)) for i in range(6)]
        for h in hs:
            h.result(60.0)
        g = s.serving_gauges()
        assert g["health.w0.0"]["last"] == HEALTH_READY
        assert g["health.w0.1"]["last"] == HEALTH_READY
        assert g["health.w1.0"]["last"] == HEALTH_DEAD   # quarantined
    finally:
        s.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_unsupervised_keeps_paper_semantics(ens2):
    """Without supervision the seed behavior is unchanged: a worker crash
    posts the global OOM sentinel and fails every in-flight request."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="predictor", kind="raise", after=0,
                             worker="w0.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=300, fault_plan=fp, supervise=False)
    try:
        h = s.predict_async(_X(48))
        with pytest.raises(MemoryError):
            h.result(30.0)
    finally:
        s.shutdown()
