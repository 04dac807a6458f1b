"""tests/test_serving_hotpath.py on the PyTorch port: combine rules under
member subsets, shape-bucket batching round-trips, device-partial message
reduction, multi-request pipelining and the per-request input buffers.
Each test names its JAX counterpart and runs its body on the port's
``InferenceSystem`` with the same parameters, params bridged from the JAX
package through numpy.  ``Y`` is held to the JAX forwards (the JAX file's
oracle) at its ``atol=2e-5``; message counts are held exactly, to the JAX
file's literals and, where it only bounds them, to the JAX system's own
count on the same request."""
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
from repro.serving.worker import bucket_for as jbucket_for  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceSystem  # noqa: E402
from repro_torch.serving.worker import bucket_for  # noqa: E402

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
    """tests/test_serving_hotpath.py's oracle, the members' scores ``L``
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


def _X(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, SEQ)
                                                ).astype(np.int32)


# ---- shape buckets ----------------------------------------------------------

def test_bucket_for_shapes():
    """test_serving_hotpath.py::test_bucket_for_shapes, and every (n, batch)
    up to 130 x {8, 16, 64} equal to the JAX function's."""
    assert bucket_for(8, 8) == 8
    assert bucket_for(3, 8) == 8
    assert bucket_for(9, 16) == 16
    assert bucket_for(17, 64) == 32
    assert bucket_for(33, 64) == 64
    assert bucket_for(5, 64) == 8
    assert bucket_for(64, 64) == 64
    assert bucket_for(100, 64) == 64
    for b in (8, 16, 64):
        for n in range(1, 131):
            assert bucket_for(n, b) == jbucket_for(n, b), (n, b)


@pytest.fixture(scope="module")
def roundtrip_ys(ens2):
    """One port system ([[8, 16]], segment 32) answering every size of
    test_batcher_padding_roundtrip in turn, as the JAX test's fresh
    systems do one each."""
    jcfgs, tcfgs, jparams, tparams = ens2
    Xs = [_X(n, n) for n in ROUNDTRIP_SIZES]
    with make_system(tcfgs, tparams, np.array([[8, 16]]),
                     segment_size=32) as s:
        Ys = [s.predict(x) for x in Xs]
    want = np.split(oracle(member_logits(jcfgs, jparams, np.concatenate(Xs))),
                    np.cumsum(ROUNDTRIP_SIZES)[:-1])
    return dict(zip(ROUNDTRIP_SIZES, zip(Ys, want)))


ROUNDTRIP_SIZES = [1, 7, 8, 9, 20, 31, 32, 70]


@pytest.mark.parametrize("n", ROUNDTRIP_SIZES)
def test_batcher_padding_roundtrip(ens2, roundtrip_ys, n):
    """test_serving_hotpath.py::test_batcher_padding_roundtrip: every
    request size survives the ring fill / bucket pad / unpad path."""
    tcfgs = ens2[1]
    Y, want = roundtrip_ys[n]
    assert Y.shape == (n, tcfgs[0].vocab_size)
    np.testing.assert_allclose(Y, want, atol=2e-5)


# ---- combine rules under member subsets ------------------------------------

def test_weighted_combine_member_subset(ens2):
    """test_serving_hotpath.py::test_weighted_combine_member_subset."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(20, 2)
    w = np.array([0.8, 0.2], np.float32)
    with make_system(tcfgs, tparams, np.array([[8, 8]]), combine="weighted",
                     weights=w, segment_size=16) as s:
        y0 = s.predict(X, members=[0])        # weights renormalize to 1.0
        y1 = s.predict(X, members=[1])
    L = member_logits(jcfgs, jparams, X)
    np.testing.assert_allclose(y0, oracle(L, [0]), atol=2e-5)
    np.testing.assert_allclose(y1, oracle(L, [1]), atol=2e-5)


@pytest.mark.parametrize("device_combine", [True, False])
def test_vote_combine_member_subset(ens2, device_combine):
    """test_serving_hotpath.py::test_vote_combine_member_subset; the votes
    are also the JAX members' argmax votes."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(20, 3)
    with make_system(tcfgs, tparams, np.array([[8, 8]]), combine="vote",
                     segment_size=16, device_combine=device_combine) as s:
        y_all = s.predict(X)
        y_sub = s.predict(X, members=[0])
    np.testing.assert_allclose(y_all.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(y_sub.max(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(y_sub.sum(axis=1), 1.0, atol=1e-6)
    votes = member_logits(jcfgs, jparams, X).argmax(axis=-1)
    np.testing.assert_array_equal(y_sub.argmax(axis=1), votes[0])
    want = np.zeros_like(y_all)
    for v in votes:
        want[np.arange(len(v)), v] += 1 / len(votes)
    np.testing.assert_allclose(y_all, want, atol=1e-6)


@pytest.mark.parametrize("device_combine", [True, False])
@pytest.mark.parametrize("n", [37, 40])       # 37: non-block-aligned segments
def test_pallas_combine_non_aligned(ens2, device_combine, n):
    """test_serving_hotpath.py::test_pallas_combine_non_aligned."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(n, 4)
    with make_system(tcfgs, tparams, np.array([[8, 8]]),
                     segment_size=16) as s:
        Y_mean = s.predict(X)
    with make_system(tcfgs, tparams, np.array([[8, 8]]), combine="pallas",
                     segment_size=16, device_combine=device_combine) as s:
        Y_pallas = s.predict(X)
        Y_sub = s.predict(X, members=[1])
    np.testing.assert_allclose(Y_mean, Y_pallas, atol=1e-5)
    L = member_logits(jcfgs, jparams, X)
    np.testing.assert_allclose(Y_pallas, oracle(L), atol=2e-5)
    np.testing.assert_allclose(Y_sub, oracle(L, [1]), atol=2e-5)


# ---- device-resident partial combine ---------------------------------------

def test_partial_combine_message_reduction(ens2):
    """test_serving_hotpath.py::test_partial_combine_message_reduction:
    one partial per device per segment (4), or M x segments (8) with the
    host combine."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(64, 5)
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     device_combine=True) as s:
        before = s.accumulator.data_messages
        Y1 = s.predict(X)
        assert s.accumulator.data_messages - before == 4
        assert s.combiners and all(c.partials_posted for c in
                                   s.combiners.values())
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     device_combine=False) as s:
        before = s.accumulator.data_messages
        Y2 = s.predict(X)
        assert s.accumulator.data_messages - before == 8
    np.testing.assert_allclose(Y1, Y2, atol=2e-5)
    np.testing.assert_allclose(Y1, oracle(member_logits(jcfgs, jparams, X)),
                               atol=2e-5)


def test_partial_combine_data_parallel(ens2):
    """test_serving_hotpath.py::test_partial_combine_data_parallel: the
    JAX test bounds the messages (< 14); here they equal the JAX system's
    count on the same request, and each device's partials too."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(100, 6)
    A = np.array([[8, 8],
                  [16, 0]])
    with make_system(tcfgs, tparams, A, segment_size=16,
                     device_combine=True) as s:
        before = s.accumulator.data_messages
        Y = s.predict(X)
        msgs = s.accumulator.data_messages - before
        posted = [s.combiners[d].partials_posted for d in sorted(s.combiners)]
    with jax_system(jcfgs, jparams, A, segment_size=16,
                    device_combine=True) as js:
        before = js.accumulator.data_messages
        js.predict(X)
        jmsgs = js.accumulator.data_messages - before
        jposted = [js.combiners[d].partials_posted
                   for d in sorted(js.combiners)]
    assert msgs < 14
    assert msgs == jmsgs and posted == jposted, (msgs, jmsgs, posted, jposted)
    np.testing.assert_allclose(Y, oracle(member_logits(jcfgs, jparams, X)),
                               atol=2e-5)


# ---- multi-request pipelining ----------------------------------------------

def test_predict_async_overlap(ens2):
    """test_serving_hotpath.py::test_predict_async_overlap."""
    jcfgs, tcfgs, jparams, tparams = ens2
    rng = np.random.default_rng(7)
    Xs = [rng.integers(0, 512, (24 + 8 * i, SEQ)).astype(np.int32)
          for i in range(5)]
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     max_in_flight=3) as s:
        handles = [s.predict_async(x) for x in Xs]
        Ys = [h.result(120.0) for h in handles]
    want = oracle(member_logits(jcfgs, jparams, np.concatenate(Xs)))
    np.testing.assert_allclose(np.concatenate(Ys), want, atol=2e-5)


def _slots_back(s, n, timeout=10.0):
    """Wait until all ``n`` window slots are free again (a slot is given
    back just after its request's answer is set)."""
    deadline = time.perf_counter() + timeout
    while s._inflight._value < n:
        assert time.perf_counter() < deadline, s._inflight
        time.sleep(0.002)


def test_inflight_window_bounded(ens2):
    """test_serving_hotpath.py::test_inflight_window_bounded: ten requests
    through a window of two all complete, no more than two are held at
    once, and every slot comes back."""
    _, tcfgs, _, tparams = ens2
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     max_in_flight=2, fake=True) as s:
        handles, held = [], []
        for _ in range(10):
            handles.append(s.predict_async(np.zeros((8, SEQ), np.int32)))
            held.append(s.max_in_flight - s._inflight._value)
        for h in handles:
            assert np.all(h.result(60.0) == 0)
        assert max(held) <= 2, held
        _slots_back(s, 2)


def test_buffer_swap_race_fixed(ens2):
    """test_serving_hotpath.py::test_buffer_swap_race_fixed: each request
    owns its buffer, so a growing later request cannot change an earlier
    one's answer."""
    jcfgs, tcfgs, jparams, tparams = ens2
    rng = np.random.default_rng(8)
    small = rng.integers(0, 512, (16, SEQ)).astype(np.int32)
    big = rng.integers(0, 512, (160, SEQ)).astype(np.int32)
    want_small, want_big = np.split(
        oracle(member_logits(jcfgs, jparams, np.concatenate([small, big]))),
        [len(small)])
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     max_in_flight=4) as s:
        for _ in range(3):                 # interleave growing requests
            h_small = s.predict_async(small)
            h_big = s.predict_async(big)
            np.testing.assert_allclose(h_small.result(120.0), want_small,
                                       atol=2e-5)
            np.testing.assert_allclose(h_big.result(120.0), want_big,
                                       atol=2e-5)


def test_bad_members_do_not_leak_window_slots(ens2):
    """test_serving_hotpath.py::test_bad_members_do_not_leak_window_slots:
    a rejected submit releases its in-flight slot."""
    _, tcfgs, _, tparams = ens2
    X = np.zeros((8, SEQ), np.int32)
    with make_system(tcfgs, tparams, np.array([[8, 8]]), segment_size=16,
                     fake=True, max_in_flight=2) as s:
        for _ in range(5):
            with pytest.raises(ValueError, match="out of range"):
                s.predict(X, members=[7])
        assert s._inflight._value == 2          # no slot leaked
        handles = [s.predict_async(X) for _ in range(4)]
        for h in handles:
            h.result(30.0)
        _slots_back(s, 2)


def test_stage_timings_populated(ens2):
    """test_serving_hotpath.py::test_stage_timings_populated: the same
    stage keys as the JAX system's, each counted."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(32, 9)
    with make_system(tcfgs, tparams, np.array([[8, 8]]),
                     segment_size=16) as s:
        s.predict(X)
        stages = s.stage_timings()
    for key in ("batcher_wait", "batch_fill", "predict", "transfer",
                "combine", "accumulate"):
        assert key in stages and stages[key]["count"] > 0, (key, stages)
