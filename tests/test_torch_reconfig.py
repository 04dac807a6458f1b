"""Online reconfiguration in the PyTorch port, ported from tests/test_reconfig.py,
plus the replanner's parity with the JAX package.

Online-reconfiguration tests: live instance spawn/drain with
zero dropped or corrupted in-flight requests (exact-result assertions),
cross-worker work stealing with expected-map migration (bit-identical
combine results vs no-steal, member subsets, device_combine parity),
re-entrant quiesce, deadline-aware linger, the LiveBench profile, and the
controller's replan/apply loop."""
import functools
import queue
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import (AllocationMatrix, AnalyticBench,  # noqa: E402
                              host_cpus)
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.admission import AdmissionQueue  # noqa: E402
from repro_torch.serving.combiner import DeviceCombiner  # noqa: E402
from repro_torch.serving.control import (LiveBench,  # noqa: E402
                                         ReconfigController)
from repro_torch.serving.control.stealing import (  # noqa: E402
    balance_member, steal_from)
from repro_torch.serving.segments import (  # noqa: E402
    FLUSH, PRIORITY_HIGH, DeadlineExceeded, PredictOptions, Request)
from repro_torch.serving.system import InferenceSystem  # noqa: E402
from repro_torch.serving.worker import Worker  # noqa: E402

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
    devs = host_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs], A)
    return InferenceSystem(cfgs, params, alloc, max_seq=SEQ, **kw)


# ---- AdmissionQueue.steal ----------------------------------------------------

def test_admission_queue_steal_order_sentinels_and_priority():
    q = AdmissionQueue()
    items = [(f"r{i}", 0) for i in range(6)]
    for it in items:
        q.put(it)
    assert q.steal(2) == items[4:]        # newest first, order preserved
    assert q.qsize() == 4
    assert [q.get_nowait() for _ in range(4)] == items[:4]   # head untouched
    q.put(("a", 0))
    q.put(FLUSH)                          # draining marker at the tail
    q.put(("b", 0))
    assert q.steal(10) == [("b", 0)]      # stops at the sentinel
    q2 = AdmissionQueue()
    q2.put(("hi", 0), PRIORITY_HIGH)
    assert q2.steal(10) == []             # high-priority work is never stolen


def test_admission_queue_drain_descriptors_moves_both_classes():
    """Drain-side migration pops BOTH priority classes (high first, FIFO
    within each) and leaves sentinels in place for the retiring batcher."""
    q = AdmissionQueue()
    q.put(("n0", 0))
    q.put(FLUSH)
    q.put(("n1", 0))
    q.put(("h0", 0), PRIORITY_HIGH)
    q.put(("h1", 0), PRIORITY_HIGH)
    assert q.drain_descriptors() == [("h0", 0), ("h1", 0),
                                     ("n0", 0), ("n1", 0)]
    assert q.qsize() == 1                 # the FLUSH sentinel stays
    assert q.get_nowait() == FLUSH


# ---- combiner expected-map migration -----------------------------------------

def _mk_request(n, num_classes=8, segment_size=16, members=(0, 1),
                weights=(0.6, 0.4)):
    return Request(0, np.zeros((n, SEQ), np.int32), n, num_classes,
                   segment_size, list(members),
                   {m: w for m, w in zip(members, weights)}, "weighted")


def test_combiner_unexpect_flushes_early_and_dest_closes():
    """Stealing member 0's descriptor off device A after member 1's rows
    already folded must flush A's partial immediately (count=1); the
    destination combiner then closes with member 0's rows alone.  The two
    partials sum to exactly the no-steal combine."""
    req = _mk_request(12)
    rng = np.random.default_rng(0)
    P0 = rng.normal(size=(12, 8)).astype(np.float32)
    P1 = rng.normal(size=(12, 8)).astype(np.float32)
    qa, qb = queue.Queue(), queue.Queue()
    a, b = DeviceCombiner("dA", qa), DeviceCombiner("dB", qb)
    a.begin(req, {0: 2})                  # both members expected on dA
    a.add(req, 0, 1, P1)                  # member 1 lands before the steal
    assert qa.empty()
    assert a.unexpect(req, 0)             # member 0's descriptor stolen away
    msg_a = qa.get_nowait()               # dA closed early with count=1
    assert msg_a.count == 1 and msg_a.m is None
    np.testing.assert_array_equal(msg_a.P, 0.4 * P1)
    assert not a._parts and not a._expected
    b.expect_one(req, 0)                  # destination side of the steal
    b.add(req, 0, 0, P0)
    msg_b = qb.get_nowait()
    assert msg_b.count == 1
    np.testing.assert_array_equal(msg_b.P, 0.6 * P0)
    np.testing.assert_allclose(msg_a.P + msg_b.P, 0.6 * P0 + 0.4 * P1,
                               atol=1e-6)


def test_combiner_unexpect_before_any_fold_moves_whole_expectation():
    req = _mk_request(10)
    qa = queue.Queue()
    a = DeviceCombiner("dA", qa)
    a.begin(req, {0: 2})
    assert a.unexpect(req, 0)
    assert qa.empty()                     # nothing folded yet: no flush
    assert a._expected[req.rid][0] == (1, 10)
    assert a.unexpect(req, 0)             # last member leaves the device
    assert not a._expected and qa.empty()
    assert not a.unexpect(req, 0)         # now untracked: refuse


# ---- end-to-end steal: bit-identical results, maps migrate -------------------

def _stall_batcher(monkeypatch, worker_ids):
    """Freeze the named workers' batchers until the returned event is set —
    descriptors routed to them sit in their admission queues, giving the
    steal tests a deterministic backlog."""
    release = threading.Event()
    orig = Worker._batcher

    def stalling(self):
        if self.worker_id in worker_ids:
            release.wait(60.0)
        return orig(self)

    monkeypatch.setattr(Worker, "_batcher", stalling)
    return release


@pytest.mark.parametrize("device_combine", [True, False])
def test_steal_end_to_end_bit_identical(ens2, monkeypatch, device_combine):
    """Stolen descriptors produce bit-identical results vs no-steal,
    including member subsets, with and without the device combine.  The
    victim's batcher is frozen, so every one of its descriptors completes
    via the sibling — proving the re-route AND the expected-map migration
    (the request could never finish otherwise)."""
    cfgs, params = ens2
    A = np.array([[8, 8],
                  [8, 0]])                # member 0 data-parallel on d0+d1
    member_sets = [[0], [0, 1], [0], [0, 1]]
    rng = np.random.default_rng(5)
    Xs = [rng.integers(0, 512, (24, SEQ)).astype(np.int32)
          for _ in member_sets]

    with make_system(cfgs, params, A, segment_size=32,
                     device_combine=device_combine, max_in_flight=8) as ref:
        Y_ref = [ref.predict(x, members=m, timeout=120.0)
                 for x, m in zip(Xs, member_sets)]

    release = _stall_batcher(monkeypatch, {"w0.0"})
    with make_system(cfgs, params, A, segment_size=32,
                     device_combine=device_combine, max_in_flight=8) as s:
        try:
            w_stalled = [w for w in s.instances(0)
                         if w.worker_id == "w0.0"][0]
            w_sibling = [w for w in s.instances(0) if w is not w_stalled][0]
            handles = [s.predict_async(x, members=m)
                       for x, m in zip(Xs, member_sets)]
            assert w_stalled.input_queue.qsize() > 0
            # re-route EVERYTHING queued on the frozen instance
            moved = steal_from(s, w_stalled, w_sibling, max_items=100)
            assert moved > 0
            # all requests complete although w0.0 never ran its batcher
            Ys = [h.result(120.0) for h in handles]
        finally:
            release.set()
    for y, y_ref in zip(Ys, Y_ref):
        np.testing.assert_array_equal(y, y_ref)


def test_balance_member_uses_drain_time_not_depth(ens2, monkeypatch):
    """With a live profile, the balancer weighs backlog by measured service
    time: a fast sibling with the deeper queue must NOT be stolen from."""
    cfgs, params = ens2
    A = np.array([[8, 8],
                  [8, 0]])
    release = _stall_batcher(monkeypatch, {"w0.0", "w1.0"})
    with make_system(cfgs, params, A, segment_size=32, fake=True,
                     max_in_flight=16) as s:
        try:
            lb = LiveBench(cfgs, seq=SEQ)
            w0 = [w for w in s.instances(0) if w.worker_id == "w0.0"][0]
            w1 = [w for w in s.instances(0) if w.worker_id == "w1.0"][0]
            # profile says w0's device serves segments 10x faster
            lb.observe(0, w0.device.key(), 8, 8, 0.001)
            lb.observe(0, w1.device.key(), 8, 8, 0.010)
            for _ in range(6):            # stripe 3 descriptors to each
                s.predict_async(np.zeros((32, SEQ), np.int32), members=[0])
            d0, d1 = w0.input_queue.qsize(), w1.input_queue.qsize()
            assert d0 == d1 == 3          # equal depth...
            moved = balance_member(s, 0, threshold=1, max_items=100,
                                   profile=lb)
            # ...but very different drain times: work moves to the fast w0
            assert moved > 0
            assert w0.input_queue.qsize() > w1.input_queue.qsize()
        finally:
            release.set()


# ---- live rebalance: spawn + drain under load --------------------------------

def test_live_rebalance_spawn_drain_exact_results(ens2):
    """A live rebalance (instance add + drain) mid-stream completes with
    zero dropped or corrupted in-flight requests: every prediction is
    bit-identical to a static system's."""
    cfgs, params = ens2
    A = np.array([[8, 8],
                  [0, 0]])                # d1 idle at deploy time
    rng = np.random.default_rng(6)
    Xs = [rng.integers(0, 512, (40, SEQ)).astype(np.int32)
          for _ in range(12)]

    with make_system(cfgs, params, A, segment_size=32,
                     max_in_flight=4) as ref:
        Y_ref = [ref.predict(x, timeout=120.0) for x in Xs]

    with make_system(cfgs, params, A, segment_size=32, max_in_flight=4) as s:
        handles = [s.predict_async(x) for x in Xs[:4]]
        w_new = s.spawn_instance(1, 0, 8)         # same compiled batch
        assert s.alloc.A[1, 0] == 8
        handles += [s.predict_async(x) for x in Xs[4:8]]
        old = [w for w in s.instances(0) if w is not w_new][0]
        s.drain_instance(old, wait=True)          # migrate + retire
        assert s.alloc.A[0, 0] == 0
        assert s.instances(0) == [w_new]
        handles += [s.predict_async(x) for x in Xs[8:]]
        Ys = [h.result(120.0) for h in handles]
    for y, y_ref in zip(Ys, Y_ref):
        np.testing.assert_array_equal(y, y_ref)


def test_drain_with_queued_backlog_migrates(ens2, monkeypatch):
    """Draining an instance whose queue is deep re-routes the backlog to
    siblings instead of waiting it out — and nothing is lost."""
    cfgs, params = ens2
    A = np.array([[8, 8],
                  [8, 0]])
    release = _stall_batcher(monkeypatch, {"w0.0"})
    with make_system(cfgs, params, A, segment_size=32,
                     max_in_flight=8) as s:
        try:
            rng = np.random.default_rng(7)
            Xs = [rng.integers(0, 512, (24, SEQ)).astype(np.int32)
                  for _ in range(6)]
            w_stalled = [w for w in s.instances(0)
                         if w.worker_id == "w0.0"][0]
            opts = PredictOptions(priority="high")
            handles = [s.predict_async(x, members=[0]) for x in Xs]
            # high-priority work queued on the victim must migrate too
            handles.append(s.predict_async(Xs[0], members=[0], options=opts))
            handles.append(s.predict_async(Xs[1], members=[0], options=opts))
            assert w_stalled.input_queue.qsize() > 0
            # drain the frozen worker: its queue must migrate, not block
            s.drain_instance(w_stalled, wait=False)
            Ys = [h.result(120.0) for h in handles]
            assert all(y.shape == (24, cfgs[0].vocab_size) for y in Ys)
        finally:
            release.set()


def test_spawn_racing_shutdown_never_registers(ens2, monkeypatch):
    """A spawn whose warm-up overlaps shutdown() must not splice a live
    worker into the dead system (leaked threads, post-shutdown mutation)."""
    cfgs, params = ens2
    s = make_system(cfgs, params, np.array([[8, 8], [0, 0]]),
                    segment_size=32, fake=True)
    orig = InferenceSystem._make_worker

    def slow_make(self, *a, **kw):
        w = orig(self, *a, **kw)
        threading.Thread(target=s.shutdown).start()   # race the registration
        time.sleep(0.3)
        return w

    monkeypatch.setattr(InferenceSystem, "_make_worker", slow_make)
    with pytest.raises(RuntimeError, match="shut down"):
        s.spawn_instance(1, 0, 8)
    assert all(w.device_idx == 0 for w in s.workers)
    assert s.alloc.A[1, 0] == 0


def test_submit_racing_shutdown_fails_fast(ens2):
    """predict_async blocked on the in-flight window when shutdown() lands
    must raise instead of enqueuing descriptors behind SHUTDOWN (where the
    batcher would discard them and the handle would hang)."""
    cfgs, params = ens2
    s = make_system(cfgs, params, np.array([[8, 8]]), segment_size=32,
                    fake=True, fake_delay_us=50_000, max_in_flight=1)
    h = s.predict_async(np.zeros((32, SEQ), np.int32))   # fills the window
    errs = []

    def submit():
        try:
            s.predict_async(np.zeros((32, SEQ), np.int32))
        except RuntimeError as e:
            errs.append(e)
    t = threading.Thread(target=submit)
    t.start()
    time.sleep(0.05)                      # submitter is blocked on the window
    s.shutdown()
    t.join(30.0)
    assert not t.is_alive() and len(errs) == 1


def test_drain_sole_instance_refused(ens2):
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=32,
                     fake=True) as s:
        with pytest.raises(ValueError, match="sole instance"):
            s.drain_instance(s.instances(0)[0])


def test_zero_work_requests_resolve_without_the_pipeline(ens2):
    """Regression: an empty member list or 0-row input must resolve
    immediately instead of completing synchronously inside _submit — the
    completion callback takes the topology lock the submitter holds
    (self-deadlock caught in review)."""
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True) as s:
        y = s.predict_async(np.zeros((5, SEQ), np.int32),
                            members=[]).result(10.0)
        assert y.shape == (5, cfgs[0].vocab_size) and np.all(y == 0)
        y = s.predict_async(np.zeros((0, SEQ), np.int32)).result(10.0)
        assert y.shape == (0, cfgs[0].vocab_size)
        # the system is still alive afterwards
        assert s.predict(np.zeros((3, SEQ), np.int32),
                         timeout=30.0).shape == (3, cfgs[0].vocab_size)


# ---- re-entrant quiesce ------------------------------------------------------

def test_quiesce_then_predict_cycles(ens2):
    """Regression: quiesce() -> predict_async() ->
    quiesce() cycles are legal — quiesce is a flush, not a teardown — and
    quiesce(wait=True) blocks until every batcher processed its flush."""
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True, max_wait_us=30_000_000) as s:
        for _ in range(3):
            h = s.predict_async(np.zeros((3, SEQ), np.int32))
            time.sleep(0.05)
            assert not h.done.is_set()    # lingering in an open slot
            assert s.quiesce(wait=True, timeout=30.0)
            assert np.all(h.result(30.0) == 0)
        # quiesce stays legal across a topology change
        s.spawn_instance(0, 0, 8)
        h = s.predict_async(np.zeros((5, SEQ), np.int32))
        assert s.quiesce(wait=True, timeout=30.0)
        assert h.result(30.0).shape == (5, cfgs[0].vocab_size)


# ---- deadline-aware linger ---------------------------------------------------

def test_deadline_bounds_linger(ens2):
    """A tight-deadline row never waits out a full linger: the open slot's
    deadline is clamped to half the row's remaining deadline budget
    (ROADMAP item f)."""
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True, max_wait_us=30_000_000) as s:
        t0 = time.perf_counter()
        Y = s.predict(np.zeros((3, SEQ), np.int32), timeout=30.0,
                      options=PredictOptions(deadline_ms=4000))
        elapsed = time.perf_counter() - t0
        assert elapsed < 3.5              # flushed at ~2s, not the 30s linger
        assert np.all(Y == 0)


def test_deadline_linger_expired_request_still_fails_fast(ens2):
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True, max_wait_us=30_000_000) as s:
        h = s.predict_async(np.zeros((3, SEQ), np.int32),
                            options=PredictOptions(deadline_ms=0.01))
        with pytest.raises(DeadlineExceeded):
            h.result(30.0)


# ---- LiveBench ---------------------------------------------------------------

def test_livebench_profile_fallback_and_demand():
    cfgs = ensemble("ENS4")[:2]
    devs = host_cpus(2, memory_bytes=8 * 1024 ** 3)
    lb = LiveBench(cfgs, seq=SEQ, alpha=0.5)
    key = devs[0].key()
    lb.observe(0, key, 8, 8, 0.010)
    lb.observe(0, key, 8, 8, 0.020)       # EWMA moves toward the new sample
    assert lb.worker_time(devs[0], 0, 8) == pytest.approx(0.015)
    # nearest-bucket scaling with an overhead floor
    assert lb.worker_time(devs[0], 0, 32) == pytest.approx(0.015 * 4)
    assert lb.worker_time(devs[0], 0, 1) == pytest.approx(0.015 * 0.25)
    # unseen (member, device): roofline fallback
    analytic = AnalyticBench(cfgs, seq=SEQ)
    assert lb.worker_time(devs[1], 1, 8) == \
        pytest.approx(analytic.worker_time(devs[1], cfgs[1], 8))
    # segment_time: None when cold, chunks x per-chunk when warm
    assert lb.segment_time(1, devs[1].key(), 8, 32) is None
    assert lb.segment_time(0, key, 8, 32) == pytest.approx(0.015 * 4)
    # demand shares drift with traffic
    for _ in range(50):
        lb.note_request([0], 32)
    shares = lb.demand_shares()
    assert shares[0] > 0.9 and shares[0] + shares[1] == pytest.approx(1.0)


def test_livebench_bench_prefers_capacity_for_the_hot_member():
    cfgs = ensemble("ENS4")[:2]
    devs = host_cpus(2, memory_bytes=8 * 1024 ** 3)
    names = [c.name for c in cfgs]
    lb = LiveBench(cfgs, seq=SEQ)
    for d in devs:                        # uniform measured latencies
        for m in (0, 1):
            lb.observe(m, d.key(), 8, 8, 0.010)
    for _ in range(50):                   # member 0 runs 4x hot
        lb.note_request([0], 32)
        lb.note_request([0], 32)
        lb.note_request([0], 32)
        lb.note_request([0, 1], 32)
    extra_m0 = AllocationMatrix(devs, names, np.array([[8, 8], [8, 0]]))
    extra_m1 = AllocationMatrix(devs, names, np.array([[8, 8], [0, 8]]))
    assert lb(extra_m0) > lb(extra_m1)    # capacity should follow demand
    assert lb(AllocationMatrix(devs, names, np.zeros((2, 2), int))) == 0.0


# ---- the controller ----------------------------------------------------------

def test_controller_replans_under_demand_skew(ens2):
    """The replan loop: a hot member under 4:1 skew makes the bounded
    greedy (scored by the live bench) claim the idle device; the delta
    applies live and requests keep completing correctly."""
    cfgs, params = ens2
    A = np.array([[8, 8],
                  [0, 0]])                # d1 idle at deploy time
    X = np.random.default_rng(8).integers(0, 512, (64, SEQ)).astype(np.int32)
    with make_system(cfgs, params, A, segment_size=32,
                     max_in_flight=8) as s:
        Y_ref = s.predict(X, timeout=120.0)
        ctl = ReconfigController(s, replan=True, steal=True,
                                 batch_sizes=(8, 16), max_iter=2,
                                 max_neighs=16, min_observations=8)
        assert s.controller is ctl
        assert not ctl.replan_once()      # profile too cold to act
        for i in range(8):                # 4:1 member skew
            s.predict(X, members=[0] if i % 5 else [0, 1], timeout=120.0)
        assert ctl.replan_once()
        assert s.generation == 1
        assert ctl.counters["applied"] == 1 and ctl.counters["spawns"] >= 1
        assert int(s.alloc.A[1].sum()) > 0         # the idle device is used
        assert s.alloc.is_valid()
        np.testing.assert_allclose(s.predict(X, timeout=120.0), Y_ref,
                                   atol=2e-5)
        stats = ctl.stats()
        assert stats["generation"] == 1
        assert stats["live"]["observations"] > 0
        assert any(e["kind"] == "applied" for e in stats["events"])


def test_controller_apply_rebatch(ens2):
    """A batch-bucket change applies as a generation-tagged replacement:
    spawn the new-batch instance, then drain the old one — the member
    stays served throughout and results stay correct."""
    cfgs, params = ens2
    A = np.array([[8, 8]])
    X = np.random.default_rng(9).integers(0, 512, (40, SEQ)).astype(np.int32)
    with make_system(cfgs, params, A, segment_size=32,
                     max_in_flight=4) as s:
        Y_ref = s.predict(X, timeout=120.0)
        ctl = ReconfigController(s, replan=False, steal=False)
        devs = s.alloc.devices
        target = AllocationMatrix(devs, s.alloc.model_names,
                                  np.array([[16, 8]]))
        ctl.apply(target)
        assert s.alloc.A.tolist() == [[16, 8]]
        (w,) = s.instances(0)
        assert w.batch_size == 16 and w.generation == 1
        assert ctl.counters["rebatches"] == 1
        np.testing.assert_allclose(s.predict(X, timeout=120.0), Y_ref,
                                   atol=2e-5)
    np.testing.assert_allclose(Y_ref, oracle(cfgs, X), atol=2e-5)


def test_controller_steal_loop_with_simulated_devices(ens2):
    """The fast path end-to-end on simulated device time: a slow batch-8
    instance backlogs while its batch-128 sibling idles; the controller's
    balancer moves the backlog and everything completes."""
    cfgs, params = ens2
    A = np.array([[8, 0],
                  [128, 128]])
    with make_system(cfgs, params, A, segment_size=128, fake=True,
                     fake_delay_us=3000, max_in_flight=20,
                     max_wait_us=200) as s:
        ctl = ReconfigController(s, replan=False, steal=True,
                                 steal_interval_s=0.001, steal_threshold=1,
                                 steal_max=64).start()
        for _ in range(2):                # warm the live profile
            s.predict(np.zeros((128, SEQ), np.int32), members=[0])
        handles = [s.predict_async(np.zeros((128, SEQ), np.int32),
                                   members=[0]) for _ in range(20)]
        for h in handles:
            assert np.all(h.result(120.0) == 0)
        assert ctl.counters["stolen"] > 0
        ctl.stop()


def test_replan_picks_the_jax_package_target(ens2):
    """Given the same LiveBench observations on the same cells, the port's
    replanner and the JAX package's pick the same target matrix."""
    from repro.core import AllocationMatrix as JAllocationMatrix
    from repro.core import host_cpus as jhost_cpus
    from repro.serving.control import ReconfigController as JController
    from repro.serving.system import InferenceSystem as JInferenceSystem
    cfgs, params = ens2
    jcfgs, jparams = _jax_ens2()
    A = np.array([[8, 8],
                  [0, 0]])                # d1 idle at deploy time
    names = [c.name for c in cfgs]
    systems = [
        (make_system(cfgs, params, A.copy(), segment_size=32, fake=True),
         ReconfigController),
        (JInferenceSystem(jcfgs, jparams,
                          JAllocationMatrix(jhost_cpus(2, 8 * 1024 ** 3),
                                            names, A.copy()),
                          max_seq=SEQ, segment_size=32, fake=True),
         JController)]
    picked = []
    for s, Controller in systems:
        with s:
            ctl = Controller(s, replan=True, steal=False,
                             batch_sizes=(8, 16), max_iter=2, max_neighs=16,
                             min_observations=8, seed=3)
            key0 = s.alloc.devices[0].key()
            for m in (0, 1):              # the same readings on cell 0
                for b, dt in ((8, 0.004), (16, 0.007)):
                    for _ in range(4):
                        ctl.live.observe(m, key0, b, b, dt * (1 + m))
            for i in range(40):           # 4:1 demand for member 0
                ctl.live.note_request([0] if i % 5 else [0, 1], 32)
            assert ctl.replan_once()
            picked.append(s.alloc.A.copy())
    assert int(picked[0][1].sum()) > 0
    np.testing.assert_array_equal(picked[0], picked[1])
