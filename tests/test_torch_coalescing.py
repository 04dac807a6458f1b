"""tests/test_coalescing.py on the PyTorch port: cross-request batch packing,
ensemble selection under coalesced batches, device_combine parity,
deterministic flush counts, row-count (not message-count) accounting in
the combiner and accumulator, the quiesce flush, mismatched-seq buffer
pooling and best-fit input-buffer reuse.  Each test names its JAX
counterpart and runs its body on the port with the same parameters, params
bridged from the JAX package through numpy.  ``Y`` is held to the JAX
forwards at the JAX file's ``atol=2e-5``; counts are held exactly, and
where the JAX test only bounds a count or reads a clock, the port's counters
are held to the JAX system's on the same fake cell."""
import queue
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.core import AllocationMatrix as JAllocationMatrix  # noqa: E402
from repro.core import host_cpus as jhost_cpus  # noqa: E402
from repro.serving.system import InferenceSystem as JInferenceSystem  # noqa: E402
from repro.serving.worker import ALT_POOL_CAP as JALT_POOL_CAP  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceSystem  # noqa: E402
from repro_torch.serving.accumulator import PredictionAccumulator  # noqa: E402
from repro_torch.serving.combiner import DeviceCombiner  # noqa: E402
from repro_torch.serving.segments import Message, Request  # noqa: E402
from repro_torch.serving.worker import ALT_POOL_CAP  # noqa: E402

SEQ = 16


@pytest.fixture(scope="module")
def ens2():
    jcfgs = jensemble("ENS4")[:2]
    rng = jax.random.PRNGKey(0)
    jparams = [M.init_params(jax.random.fold_in(rng, i), c)
               for i, c in enumerate(jcfgs)]
    tparams = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
               for p in jparams]
    return jcfgs, ensemble("ENS4")[:2], jparams, tparams


def member_logits(cfgs, params, X):
    """Each JAX member's last-token class scores for the rows of ``X``
    (M, n, C): the terms of the JAX file's oracle, one forward each."""
    return np.stack([np.asarray(M.forward(p, c, jnp.asarray(X))[0]
                                [:, -1, :c.vocab_size])
                     for c, p in zip(cfgs, params)])


def oracle(L, members=None, weights=None):
    """tests/test_coalescing.py's oracle, the members' scores ``L``
    combined in numpy with ``weights`` renormalized over ``members``."""
    members = list(range(len(L))) if members is None else members
    w = np.ones(len(L)) if weights is None else np.asarray(weights)
    w = w[members] / w[members].sum()
    return sum(L[m] * wi for m, wi in zip(members, w)).astype(np.float32)


def make_system(cfgs, params, A, **kw):
    devs = host_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs], A)
    return InferenceSystem(cfgs, params, alloc, max_seq=SEQ, **kw)


def jax_system(cfgs, params, A, **kw):
    devs = jhost_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = JAllocationMatrix(devs, [c.name for c in cfgs], A)
    return JInferenceSystem(cfgs, params, alloc, max_seq=SEQ, **kw)


def small_batch(rng, k, sizes=(3, 5, 6, 9, 12)):
    return [rng.integers(0, 512, (sizes[i % len(sizes)], SEQ)).astype(np.int32)
            for i in range(k)]


# ---- ensemble selection under coalesced batches ------------------------------

def test_members_subsets_interleaved_under_coalescing(ens2):
    """test_coalescing.py::test_members_subsets_interleaved_under_coalescing:
    rows of requests with different member subsets share batches; the
    subset weights renormalize per request."""
    jcfgs, tcfgs, jparams, tparams = ens2
    w = np.array([0.75, 0.25], np.float32)
    Xs = small_batch(np.random.default_rng(10), 12)
    member_sets = [[0], [1], [0, 1]]
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=32,
                     combine="weighted", weights=w, coalesce=True,
                     max_in_flight=12) as s:
        handles = [s.predict_async(x, members=member_sets[i % 3])
                   for i, x in enumerate(Xs)]
        Ys = [h.result(120.0) for h in handles]
        assert s.serving_counters()["spans"] > s.serving_counters()["batches"]
    Ls = np.split(member_logits(jcfgs, jparams, np.concatenate(Xs)),
                  np.cumsum([len(x) for x in Xs])[:-1], axis=1)
    for i, (L, y) in enumerate(zip(Ls, Ys)):
        np.testing.assert_allclose(y, oracle(L, member_sets[i % 3], w),
                                   atol=2e-5)


@pytest.mark.parametrize("combine", ["mean", "vote", "pallas"])
def test_device_combine_parity_under_coalescing(ens2, combine):
    """test_coalescing.py::test_device_combine_parity_under_coalescing: the
    device and the host combine agree (1e-5, the JAX file's), and both are
    the JAX oracle's answer (2e-5; votes: the JAX members' argmax)."""
    jcfgs, tcfgs, jparams, tparams = ens2
    Xs = small_batch(np.random.default_rng(11), 10)
    member_sets = [[0, 1], [1], [0]]
    outs = {}
    for dc in (True, False):
        with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=32,
                         combine=combine, coalesce=True, max_in_flight=10,
                         device_combine=dc) as s:
            handles = [s.predict_async(x, members=member_sets[i % 3])
                       for i, x in enumerate(Xs)]
            outs[dc] = [h.result(120.0) for h in handles]
    for y_dev, y_host in zip(outs[True], outs[False]):
        np.testing.assert_allclose(y_dev, y_host, atol=1e-5)
    Ls = np.split(member_logits(jcfgs, jparams, np.concatenate(Xs)),
                  np.cumsum([len(x) for x in Xs])[:-1], axis=1)
    for i, (L, y) in enumerate(zip(Ls, outs[True])):
        ms = member_sets[i % 3]
        if combine == "vote":
            want = np.zeros_like(y)
            for m in ms:
                want[np.arange(len(y)), L[m].argmax(-1)] += 1 / len(ms)
            np.testing.assert_allclose(y, want, atol=1e-6)
        else:
            np.testing.assert_allclose(y, oracle(L, ms), atol=2e-5)


def test_deterministic_flush_counts_under_coalescing(ens2):
    """test_coalescing.py::test_deterministic_flush_counts_under_coalescing:
    each (request, segment) posts exactly one device partial."""
    _, tcfgs, _, tparams = ens2
    Xs = small_batch(np.random.default_rng(12), 9, sizes=(5, 20, 40))
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     coalesce=True, max_in_flight=9) as s:
        before = s.accumulator.data_messages
        posted0 = sum(c.partials_posted for c in s.combiners.values())
        handles = [s.predict_async(x) for x in Xs]
        for h in handles:
            h.result(120.0)
        n_segments = sum(-(-x.shape[0] // 16) for x in Xs)
        assert n_segments == 18
        assert s.accumulator.data_messages - before == n_segments
        posted = sum(c.partials_posted for c in s.combiners.values()) - posted0
        assert posted == n_segments


def test_single_segment_requests_spread_across_instances(ens2):
    """test_coalescing.py::test_single_segment_requests_spread_across_instances:
    striping rotates by request id, so small requests reach model 0's
    second instance; each device's partial count equals the JAX
    system's."""
    jcfgs, tcfgs, jparams, tparams = ens2
    A = np.array([[8, 8],
                  [8, 0]])
    posted = {}
    for name, mk, cfgs, params in (("port", make_system, tcfgs, tparams),
                                   ("jax", jax_system, jcfgs, jparams)):
        with mk(cfgs, params, A, segment_size=16, fake=True, coalesce=True,
                max_in_flight=8) as s:
            handles = [s.predict_async(np.zeros((5, SEQ), np.int32))
                       for _ in range(8)]
            for h in handles:
                h.result(60.0)
            posted[name] = [s.combiners[d].partials_posted for d in (0, 1)]
    assert posted["port"][1] > 0 and posted["port"][0] > 0
    assert posted["port"] == posted["jax"] == [8, 4], posted


# ---- row-count accounting (combiner / accumulator units) ---------------------

def _mk_request(n, num_classes=8, segment_size=16, members=(0, 1),
                weights=(0.6, 0.4)):
    return Request(0, np.zeros((n, SEQ), np.int32), n, num_classes,
                   segment_size, list(members),
                   {m: w for m, w in zip(members, weights)}, "weighted")


@pytest.mark.parametrize("to_device", [False, True])
def test_combiner_counts_rows_not_messages(to_device):
    """test_coalescing.py::test_combiner_counts_rows_not_messages: a
    member's segment split across row ranges still flushes exactly once."""
    req = _mk_request(12)
    rng = np.random.default_rng(0)
    P0 = rng.normal(size=(12, 8)).astype(np.float32)
    P1 = rng.normal(size=(12, 8)).astype(np.float32)
    conv = (lambda a: torch.from_numpy(a)) if to_device else (lambda a: a)
    q = queue.Queue()
    comb = DeviceCombiner("d0", q)
    comb.begin(req, {0: 2})
    comb.add(req, 0, 0, conv(P0[:5]), row_lo=0)       # member 0, split rows
    assert q.empty() and comb.partials_posted == 0
    comb.add(req, 0, 1, conv(P1), row_lo=0)           # member 1, whole seg
    assert q.empty()                                  # rows: 5 + 12 of 24
    comb.add(req, 0, 0, conv(P0[5:]), row_lo=5)       # member 0, tail rows
    msg = q.get_nowait()
    assert q.empty()
    assert comb.partials_posted == 1 and msg.count == 2 and msg.m is None
    np.testing.assert_allclose(np.asarray(msg.P), 0.6 * P0 + 0.4 * P1,
                               atol=1e-5)
    assert not comb._parts and not comb._expected     # state fully retired


def test_combiner_pallas_rule_row_spans():
    """test_coalescing.py::test_combiner_pallas_rule_row_spans: the
    accumulate kernel's fold (its plain version on CPU tensors) with a
    member's rows arriving as spans."""
    req = _mk_request(12, num_classes=16)
    req.combine = "pallas"
    rng = np.random.default_rng(1)
    P0 = rng.normal(size=(12, 16)).astype(np.float32)
    P1 = rng.normal(size=(12, 16)).astype(np.float32)
    q = queue.Queue()
    comb = DeviceCombiner("d0", q)
    comb.begin(req, {0: 2})
    comb.add(req, 0, 0, torch.from_numpy(P0[:7]), row_lo=0)
    comb.add(req, 0, 0, torch.from_numpy(P0[7:]), row_lo=7)
    comb.add(req, 0, 1, torch.from_numpy(P1), row_lo=0)
    msg = q.get_nowait()
    assert q.empty() and comb.partials_posted == 1 and msg.count == 2
    np.testing.assert_allclose(np.asarray(msg.P), 0.6 * P0 + 0.4 * P1,
                               atol=1e-5)


def test_accumulator_counts_rows_not_messages():
    """test_coalescing.py::test_accumulator_counts_rows_not_messages: a
    request owes n x members member-rows; completion fires when they
    close."""
    req = _mk_request(10, weights=(0.5, 0.5))
    rng = np.random.default_rng(2)
    P0 = rng.normal(size=(10, 8)).astype(np.float32)
    P1 = rng.normal(size=(10, 8)).astype(np.float32)
    q = queue.Queue()
    acc = PredictionAccumulator(q, 2, combine="weighted",
                                weights=np.array([0.5, 0.5], np.float32))
    acc.start()
    try:
        handle = acc.begin(req)
        assert handle.remaining == 20                  # rows, not messages
        q.put(Message(0, 0, P0[:6], rid=0, row_lo=0))
        q.put(Message(0, 0, P0[6:], rid=0, row_lo=6))
        q.put(Message(0, 1, P1, rid=0, row_lo=0))
        Y = handle.result(30.0)
        np.testing.assert_allclose(Y, 0.5 * P0 + 0.5 * P1, atol=1e-5)
        assert handle.messages == 3
        assert handle.remaining == 0
    finally:
        acc.stop()


def test_accumulator_device_partial_debits_count_times_rows():
    """test_coalescing.py::
    test_accumulator_device_partial_debits_count_times_rows: a device
    partial debits count x rows."""
    req = _mk_request(10, weights=(0.5, 0.5))
    q = queue.Queue()
    acc = PredictionAccumulator(q, 2)
    acc.start()
    try:
        handle = acc.begin(req)
        partial = np.full((10, 8), 2.0, np.float32)
        q.put(Message(0, None, partial, rid=0, count=2))
        Y = handle.result(30.0)
        np.testing.assert_allclose(Y, partial)
        assert handle.messages == 1 and handle.remaining == 0
    finally:
        acc.stop()


# ---- linger / quiesce --------------------------------------------------------

def test_quiesce_flushes_lingering_partial_batch(ens2):
    """test_coalescing.py::test_quiesce_flushes_lingering_partial_batch:
    under an effectively infinite linger a lone small request waits in an
    open batch until quiesce() flushes it."""
    _, tcfgs, _, tparams = ens2
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True, max_wait_us=30_000_000) as s:
        h = s.predict_async(np.zeros((3, SEQ), np.int32))
        time.sleep(0.3)
        assert not h.done.is_set()          # batch is lingering open
        assert s.serving_counters().get("batches", 0) == 0
        s.quiesce()
        assert np.all(h.result(30.0) == 0)
        assert s.serving_counters()["batches"] == 2      # one per member


def test_bounded_linger_flushes_without_quiesce(ens2):
    """test_coalescing.py::test_bounded_linger_flushes_without_quiesce: a
    partial batch flushes on its own once max_wait_us runs out.  The JAX
    test bounds the seconds (< 5); here the request is answered without a
    quiesce and the batch and row counters equal the JAX system's."""
    jcfgs, tcfgs, jparams, tparams = ens2
    got = {}
    for name, mk, cfgs, params in (("port", make_system, tcfgs, tparams),
                                   ("jax", jax_system, jcfgs, jparams)):
        with mk(cfgs, params, np.array([[8, 8]]), segment_size=16,
                fake=True, coalesce=True, max_wait_us=1000) as s:
            Y = s.predict(np.zeros((3, SEQ), np.int32), timeout=30.0)
            assert Y.shape == (3, cfgs[0].vocab_size)
            c = s.serving_counters()
            got[name] = {k: c.get(k) for k in ("batches", "spans",
                                                "rows_valid",
                                                "rows_dispatched")}
    assert got["port"] == got["jax"], got
    assert got["port"]["batches"] == 2 and got["port"]["rows_valid"] == 6


# ---- buffer pooling ----------------------------------------------------------

def test_mismatched_seq_buffers_are_pooled(ens2):
    """test_coalescing.py::test_mismatched_seq_buffers_are_pooled: requests
    narrower than the compiled ring draw batcher buffers from a bounded
    per-width pool."""
    _, tcfgs, _, tparams = ens2
    assert ALT_POOL_CAP == JALT_POOL_CAP
    alt_seq = SEQ // 2
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     fake=True, coalesce=True) as s:
        for _ in range(6):
            Y = s.predict(np.zeros((20, alt_seq), np.int32), timeout=30.0)
            assert Y.shape == (20, tcfgs[0].vocab_size)
        for w in s.workers:
            pools = w._alt_pool
            assert alt_seq in pools and len(pools[alt_seq]) >= 1
            assert all(len(p) <= ALT_POOL_CAP for p in pools.values())
            assert all(b.shape == (w._span, alt_seq)
                       for b in pools[alt_seq])


def test_take_buffer_best_fit(ens2):
    """test_coalescing.py::test_take_buffer_best_fit: the smallest fitting
    pooled buffer is taken."""
    _, tcfgs, _, tparams = ens2
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     fake=True) as s:
        big = np.zeros((512, SEQ), np.int32)
        mid = np.zeros((64, SEQ), np.int32)
        small = np.zeros((32, SEQ), np.int32)
        with s._pool_lock:
            s._buffer_pool[:] = [big, mid, small]
        got = s._take_buffer(40, SEQ)
        assert got is mid                   # best fit, not first fit (big)
        with s._pool_lock:
            assert any(b is big for b in s._buffer_pool)
            assert any(b is small for b in s._buffer_pool)
            assert not any(b is mid for b in s._buffer_pool)


# ---- metrics -----------------------------------------------------------------

def test_padding_counters_and_queue_gauge(ens2):
    """test_coalescing.py::test_padding_counters_and_queue_gauge, and the
    counters equal the JAX system's on the same fake cell."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = np.random.default_rng(13).integers(0, 512, (20, SEQ)).astype(np.int32)
    got = {}
    for name, mk, cfgs, params in (("port", make_system, tcfgs, tparams),
                                   ("jax", jax_system, jcfgs, jparams)):
        with mk(cfgs, params, np.array([[8, 8]]), segment_size=16,
                fake=True, coalesce=True) as s:
            s.predict(X, timeout=30.0)
            c = s.serving_counters()
            assert c["batches"] > 0 and c["spans"] > 0
            assert 0 < c["rows_valid"] <= c["rows_dispatched"]
            assert 0 < c["padding_efficiency"] <= 1.0
            g = s.serving_gauges()
            depth_keys = [k for k in g if k.startswith("queue_depth.")]
            assert depth_keys and all(g[k]["max"] >= 0 for k in depth_keys)
            got[name] = ({k: c[k] for k in ("batches", "spans", "rows_valid",
                                            "rows_dispatched",
                                            "padding_efficiency")},
                         sorted(depth_keys))
    assert got["port"] == got["jax"], got
