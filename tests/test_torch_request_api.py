"""The request API of the PyTorch port, ported from tests/test_request_api.py:
the port's system on the host CPU, with the JAX package's parameters bridged
through numpy and its forwards as the oracle.

Unified request API tests: PredictOptions, the two-level
priority admission queue, deadlines, cancellation, the EnsembleClient
facade (sync / async / streaming / cache policies), adaptive linger, and
the AdaptiveBatcher timeout-leak fix."""
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
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.admission import AdmissionQueue  # noqa: E402
from repro_torch.serving.client import EnsembleClient  # noqa: E402
from repro_torch.serving.request_cache import PredictionCache  # noqa: E402
from repro_torch.serving.segments import (  # noqa: E402
    PRIORITY_HIGH, PRIORITY_NORMAL, DeadlineExceeded, PredictOptions,
    RequestCancelled)
from repro_torch.serving.server import AdaptiveBatcher, _Pending  # noqa: E402
from repro_torch.serving.system import InferenceSystem  # noqa: E402
from repro_torch.serving.worker import ADAPTIVE_DEPTH, Worker  # noqa: E402

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


# ---- PredictOptions ----------------------------------------------------------

def test_options_validation():
    assert PredictOptions(priority="high").level() == PRIORITY_HIGH
    assert PredictOptions().level() == PRIORITY_NORMAL
    assert PredictOptions(priority=PRIORITY_HIGH).level() == PRIORITY_HIGH
    with pytest.raises(ValueError, match="priority"):
        PredictOptions(priority="urgent")
    with pytest.raises(ValueError, match="cache"):
        PredictOptions(cache="maybe")
    with pytest.raises(ValueError, match="deadline_ms"):
        PredictOptions(deadline_ms=-5)
    assert PredictOptions().deadline_at() is None
    d = PredictOptions(deadline_ms=50).deadline_at(now=100.0)
    assert d == pytest.approx(100.05)


# ---- the admission queue -----------------------------------------------------

def test_admission_queue_priority_and_fifo():
    q = AdmissionQueue()
    q.put("n0")
    q.put("n1")
    q.put("h0", PRIORITY_HIGH)
    q.put("h1", PRIORITY_HIGH)
    assert q.qsize() == 4
    assert q.depth(PRIORITY_HIGH) == 2 and q.depth(PRIORITY_NORMAL) == 2
    # high drains first, FIFO within each class
    assert [q.get(), q.get_nowait(), q.get(0.1), q.get()] == \
        ["h0", "h1", "n0", "n1"]
    with pytest.raises(queue.Empty):
        q.get_nowait()
    with pytest.raises(queue.Empty):
        q.get(timeout=0.01)


def test_admission_queue_blocking_get():
    q = AdmissionQueue()
    got = []
    t = threading.Thread(target=lambda: got.append(q.get(timeout=5.0)))
    t.start()
    time.sleep(0.05)
    q.put("x")
    t.join(5.0)
    assert got == ["x"]


# ---- priority scheduling end-to-end ------------------------------------------

def test_high_priority_overtakes_bulk_scan(ens2):
    """A high-priority request submitted behind a saturating bulk scan
    completes while the bulk is still in flight (ROADMAP item a: no more
    strict FIFO)."""
    cfgs, params = ens2
    bulk = np.zeros((8192, SEQ), np.int32)          # 512 segments/member
    small = np.zeros((4, SEQ), np.int32)
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True) as s:
        h_bulk = s.predict_async(bulk)
        h_high = s.predict_async(small,
                                 options=PredictOptions(priority="high"))
        Y = h_high.result(60.0)
        assert Y.shape == (4, cfgs[0].vocab_size)
        assert not h_bulk.done.is_set(), \
            "high-priority request should finish while the bulk scan runs"
        h_bulk.result(120.0)


def test_high_priority_preempts_linger(ens2):
    """High-priority rows collapse the linger: with an effectively-infinite
    max_wait_us a high-priority request still completes promptly instead of
    lingering in a partial batch."""
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True, max_wait_us=30_000_000) as s:
        t0 = time.perf_counter()
        s.predict(np.zeros((3, SEQ), np.int32), timeout=30.0,
                  options=PredictOptions(priority="high"))
        assert time.perf_counter() - t0 < 5.0


# ---- deadlines ---------------------------------------------------------------

def test_deadline_fails_fast_at_admission(ens2):
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True) as s:
        h = s.predict_async(np.zeros((4, SEQ), np.int32),
                            options=PredictOptions(deadline_ms=1e-4))
        with pytest.raises(DeadlineExceeded):
            h.result(5.0)
        # the failed admission consumed no in-flight slot / ring resources
        assert np.all(s.predict(np.zeros((4, SEQ), np.int32)) == 0)


def test_deadline_expires_in_admission_queue(ens2):
    """A deadlined request queued behind a long bulk scan fails with
    DeadlineExceeded once a batcher pops it — rows are never packed."""
    cfgs, params = ens2
    bulk = np.zeros((8192, SEQ), np.int32)
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True) as s:
        rows0 = s.serving_counters().get("rows_valid", 0.0)
        s.predict_async(bulk)                        # saturate the queue
        h = s.predict_async(np.zeros((4, SEQ), np.int32),
                            options=PredictOptions(deadline_ms=1.0))
        with pytest.raises(DeadlineExceeded):
            h.result(60.0)
        # system drains and keeps serving
        assert np.all(s.predict(np.zeros((2, SEQ), np.int32),
                                timeout=120.0) == 0)
        # the expired request's rows were dropped, not dispatched: every
        # valid row belongs to the bulk scan or the follow-up request
        assert s.serving_counters()["rows_valid"] - rows0 <= \
            (8192 + 2) * len(cfgs)


# ---- cancellation ------------------------------------------------------------

def test_cancel_releases_window_and_keeps_serving(ens2):
    cfgs, params = ens2
    bulk = np.zeros((4096, SEQ), np.int32)
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True, max_in_flight=2) as s:
        h_bulk = s.predict_async(bulk)
        h2 = s.predict_async(np.zeros((4, SEQ), np.int32))
        buf2 = h2.req.x
        assert h2.cancel() is True
        with pytest.raises(RequestCancelled):
            h2.result(5.0)
        assert h2.cancel() is False            # idempotent
        # the cancelled request released its in-flight slot: with
        # max_in_flight=2 this submit would otherwise deadlock behind bulk
        h3 = s.predict_async(np.zeros((2, SEQ), np.int32))
        assert np.all(h3.result(120.0) == 0)
        h_bulk.result(120.0)
        # a cancelled request's buffer is never recycled into the pool (a
        # batcher may still read it)
        with s._pool_lock:
            assert all(b is not buf2 for b in s._buffer_pool)


def test_cancel_with_real_models_keeps_results_correct(ens2):
    """Cancelling one of several interleaved coalesced requests must not
    corrupt the surviving requests' outputs."""
    cfgs, params = ens2
    rng = np.random.default_rng(3)
    Xs = [rng.integers(0, 512, (5, SEQ)).astype(np.int32) for _ in range(6)]
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=32,
                     coalesce=True, max_in_flight=8) as s:
        handles = [s.predict_async(x) for x in Xs]
        handles[2].cancel()
        handles[4].cancel()
        for i, (x, h) in enumerate(zip(Xs, handles)):
            if i in (2, 4):
                with pytest.raises(RequestCancelled):
                    h.result(60.0)
            else:
                np.testing.assert_allclose(h.result(120.0),
                                           oracle(cfgs, x), atol=2e-5)


# ---- the EnsembleClient facade -----------------------------------------------

def test_client_members_and_combine_options(ens2):
    cfgs, params = ens2
    X = np.random.default_rng(7).integers(0, 512, (20, SEQ)).astype(np.int32)
    w = np.array([0.75, 0.25], np.float32)
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     combine="weighted", weights=w) as s:
        client = EnsembleClient(s)
        y0 = client.predict(X, PredictOptions(members=[0]))
        y_all = client.predict(X)
        y_vote = client.predict(X, PredictOptions(combine="vote"))
    np.testing.assert_allclose(y0, oracle(cfgs[:1], X), atol=2e-5)
    np.testing.assert_allclose(y_all, oracle(cfgs, X, w), atol=2e-5)
    np.testing.assert_allclose(y_vote.sum(axis=1), 1.0, atol=1e-6)


def test_client_async_handle(ens2):
    cfgs, params = ens2
    X = np.random.default_rng(8).integers(0, 512, (10, SEQ)).astype(np.int32)
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16) as s:
        client = EnsembleClient(s)
        h = client.predict_async(X)
        Y = h.result(120.0)
        assert h.done()
    np.testing.assert_allclose(Y, oracle(cfgs, X), atol=2e-5)


def test_client_streaming_partials(ens2):
    """predict_stream fires on_segment once per segment, in-order rows, and
    the concatenation equals the full prediction."""
    cfgs, params = ens2
    X = np.random.default_rng(9).integers(0, 512, (40, SEQ)).astype(np.int32)
    got = {}
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16) as s:
        client = EnsembleClient(s)
        h = client.predict_stream(
            X, lambda s_, lo, hi, Y_seg: got.setdefault(s_, (lo, hi,
                                                             Y_seg.copy())))
        Y = h.result(120.0)
    assert sorted(got) == [0, 1, 2]            # 40 rows / 16 = 3 segments
    ref = oracle(cfgs, X)
    for s_, (lo, hi, Y_seg) in got.items():
        assert (lo, hi) == (s_ * 16, min((s_ + 1) * 16, 40))
        np.testing.assert_allclose(Y_seg, ref[lo:hi], atol=2e-5)
    np.testing.assert_allclose(Y, ref, atol=2e-5)


def test_streaming_callback_exception_fails_request(ens2):
    """A raising on_segment callback resolves the request with that error
    instead of killing the accumulation loop; the system keeps serving."""
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True) as s:
        client = EnsembleClient(s)

        def boom(*a):
            raise RuntimeError("client callback exploded")

        h = client.predict_stream(np.zeros((4, SEQ), np.int32), boom)
        with pytest.raises(RuntimeError, match="exploded"):
            h.result(30.0)
        assert np.all(client.predict(np.zeros((4, SEQ), np.int32)) == 0)


def test_client_cache_policies(ens2):
    cfgs, params = ens2
    X = np.random.default_rng(11).integers(0, 512, (6, SEQ)).astype(np.int32)
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16) as s:
        cache = PredictionCache(capacity=64)
        client = EnsembleClient(s, cache=cache)
        Y1 = client.predict(X)                               # fill
        msgs = s.accumulator.data_messages
        Y2 = client.predict(X)                               # all hits
        assert s.accumulator.data_messages == msgs           # no system work
        assert cache.hits == 6
        np.testing.assert_array_equal(Y1, Y2)
        client.predict(X, PredictOptions(cache="bypass"))    # skips cache
        assert s.accumulator.data_messages > msgs
        assert cache.hits == 6                               # no extra lookup
        msgs = s.accumulator.data_messages
        client.predict(X, PredictOptions(cache="refresh"))   # recompute
        assert s.accumulator.data_messages > msgs
        # partial hit: 3 cached rows + 3 new rows -> only misses submitted
        X2 = np.vstack([X[:3], X[:3] + 1])
        Y3 = client.predict(X2)
        np.testing.assert_allclose(Y3[:3], Y1[:3], atol=1e-6)
        np.testing.assert_allclose(Y3[3:], oracle(cfgs, X[:3] + 1),
                                   atol=2e-5)
        m = client.metrics()
        assert m["cache"]["hits"] >= 9 and "counters" in m


def test_cache_keys_are_salted_by_ensemble_config(ens2):
    """A member-subset / combine-rule request must never be answered with a
    full-ensemble cache entry: the options fingerprint salts the key."""
    cfgs, params = ens2
    X = np.random.default_rng(13).integers(0, 512, (4, SEQ)).astype(np.int32)
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16) as s:
        cache = PredictionCache(capacity=64)
        client = EnsembleClient(s, cache=cache)
        client.predict(X)                                    # full ensemble
        y0 = client.predict(X, PredictOptions(members=[0]))  # must MISS
        assert cache.hits == 0 and cache.misses == 8
        np.testing.assert_allclose(y0, oracle(cfgs[:1], X),
                                   atol=2e-5)
        # and the subset entry is reusable under the same options
        y0b = client.predict(X, PredictOptions(members=[0]))
        assert cache.hits == 4
        np.testing.assert_array_equal(y0, y0b)
        # salts normalize: member order / explicit full set / explicit
        # system-default combine all collapse to the same key space
        assert client._cache_salt(PredictOptions(members=[1, 0])) == \
            client._cache_salt(PredictOptions(members=[0, 1]))
        assert client._cache_salt(PredictOptions(members=[0, 1])) == b""
        assert client._cache_salt(PredictOptions(combine=s.combine)) == b""


def test_client_requires_exactly_one_transport(ens2):
    with pytest.raises(ValueError, match="exactly one"):
        EnsembleClient()
    with pytest.raises(ValueError, match="exactly one"):
        EnsembleClient(object(), url="http://x")


# ---- adaptive linger ---------------------------------------------------------

def test_effective_linger_scales_with_depth():
    class Stub:
        linger_s = 0.5
        linger_mode = "adaptive"

        class input_queue:
            _d = 0

            @classmethod
            def qsize(cls):
                return cls._d

    stub = Stub()
    assert Worker._effective_linger(stub) == pytest.approx(0.5)   # idle
    Stub.input_queue._d = ADAPTIVE_DEPTH // 2
    assert Worker._effective_linger(stub) == pytest.approx(0.25)  # half
    Stub.input_queue._d = ADAPTIVE_DEPTH * 2
    assert Worker._effective_linger(stub) == 0.0                  # saturated
    stub.linger_mode = "fixed"
    assert Worker._effective_linger(stub) == pytest.approx(0.5)


def test_adaptive_linger_flushes_under_backlog(ens2):
    """With linger='adaptive' a deep queue collapses the linger: a burst of
    requests completes far faster than the configured max_wait_us would
    allow if each new slot waited out the full fixed linger."""
    cfgs, params = ens2
    with make_system(cfgs, params, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True, max_wait_us=2_000_000,
                     linger="adaptive", max_in_flight=32) as s:
        handles = [s.predict_async(np.zeros((24, SEQ), np.int32))
                   for _ in range(32)]
        t0 = time.perf_counter()
        for h in handles:
            assert np.all(h.result(60.0) == 0)
        assert time.perf_counter() - t0 < 2.0   # << one 2s linger per slot


def test_linger_flag_validated(ens2):
    cfgs, params = ens2
    with pytest.raises(ValueError, match="linger"):
        make_system(cfgs, params, np.array([[8, 8]]), fake=True,
                    linger="sometimes")


# ---- AdaptiveBatcher timeout leak --------------------------------------------

class _StubSystem:
    segment_size = 4

    def __init__(self):
        self.calls = []

    def predict(self, X):
        self.calls.append(X.shape[0])
        return np.zeros((X.shape[0], 3), np.float32)


def test_adaptive_batcher_drops_cancelled_pendings():
    """A timed-out _Pending is dropped at flush time instead of being
    predicted for a waiter that already gave up."""
    sys_ = _StubSystem()
    batcher = AdaptiveBatcher(sys_, max_wait_s=0.01)
    try:
        dead = _Pending(np.zeros((2, SEQ), np.int32))
        dead.cancelled = True                  # as a submit() timeout marks it
        batcher.q.put(dead)
        y = batcher.submit(np.ones((1, SEQ), np.int32), timeout=10.0)
        assert y.shape == (1, 3)
        assert sys_.calls == [1]               # cancelled rows never predicted
    finally:
        batcher.stop()


def test_adaptive_batcher_all_cancelled_batch_is_skipped():
    sys_ = _StubSystem()
    batcher = AdaptiveBatcher(sys_, max_wait_s=0.01)
    try:
        dead = _Pending(np.zeros((2, SEQ), np.int32))
        dead.cancelled = True
        batcher.q.put(dead)
        time.sleep(0.3)
        assert sys_.calls == []                # nothing live: no predict call
        assert batcher.q.qsize() == 0          # ...but the queue drained
    finally:
        batcher.stop()
