"""The system cases of tests/test_quantized.py (its end-to-end, precision
floor, dtype-aware allocator and EDF dispatch sections, its two chaos
cases and the bf16 params' round trip) and
tests/test_kv_quant.py::test_quantized_cache_halves_bytes on the PyTorch
port.  Each test names its JAX counterpart and runs its body on the
port with the same parameters, params bridged from the JAX package through
numpy; test_h2d_staging_counter's counterpart is in
tests/test_torch_staging.py.

An fp32 system's ``Y`` is held to the JAX forwards at ``atol=2e-5``.  A
system with int8 members is held to the JAX system with the same settings:
the weight codes agree, but a logit on an int8 rounding edge may take the
next code in one package, so an element may differ by one logit step per
quantized member (``w_m`` times the row's scale, from the JAX member's
dequantized forward) and by 2e-5 otherwise, and at most 1 % of elements do
so.  Byte counts are held to the JAX package's exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import AllocationMatrix as JAllocationMatrix  # noqa: E402
from repro.core import host_cpus as jhost_cpus  # noqa: E402
from repro.core import memory as jmem  # noqa: E402
from repro.core.worst_fit import worst_fit_decreasing as jwfd  # noqa: E402
from repro.kernels import quant as jq  # noqa: E402
from repro.serving.system import InferenceSystem as JInferenceSystem  # noqa: E402
from repro_torch.configs import ensemble, get_config  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.core import memory as mem  # noqa: E402
from repro_torch.core.worst_fit import worst_fit_decreasing  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.admission import (DispatchQueue,  # noqa: E402
                                           EDFDispatchQueue)
from repro_torch.serving.segments import (MemberUnavailable,  # noqa: E402
                                          PredictOptions)
from repro_torch.serving.system import InferenceSystem  # noqa: E402

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


def make_system(cfgs, params, A, **kw):
    A = np.array(A)
    devs = host_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs], A)
    kw.setdefault("max_seq", SEQ)
    return InferenceSystem(cfgs, params, alloc, **kw)


def jax_system(cfgs, params, A, **kw):
    A = np.array(A)
    devs = jhost_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = JAllocationMatrix(devs, [c.name for c in cfgs], A)
    kw.setdefault("max_seq", SEQ)
    return JInferenceSystem(cfgs, params, alloc, **kw)


def _X(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 512, (n, SEQ)).astype(np.int32)


def _rel_err(y, yref):
    return float(np.abs(y - yref).max() / max(np.abs(yref).max(), 1e-6))


def oracle(jcfgs, jparams, X, members=None, weights=None):
    """The JAX members' last-token scores, combined in numpy with
    ``weights`` renormalized over ``members``."""
    members = list(range(len(jcfgs))) if members is None else members
    w = np.ones(len(jcfgs)) if weights is None else np.asarray(weights)
    w = w[members] / w[members].sum()
    return sum(np.asarray(M.forward(jparams[m], jcfgs[m], jnp.asarray(X))[0]
                          [:, -1, :jcfgs[m].vocab_size]) * wi
               for m, wi in zip(members, w)).astype(np.float32)


def int8_steps(jcfgs, jparams, X, weights):
    """(n, 1): the sum over the int8 members ``weights`` names (member ->
    combine weight) of the weight times the row's logit scale, from the
    JAX member's forward on its dequantized int8 params."""
    out = 0.0
    for m, w in weights.items():
        p = jq.dequantize_params(jq.quantize_params(jparams[m], "int8"))
        lg, _ = M.forward(p, jcfgs[m], jnp.asarray(X))
        _, scale = jq.quantize_symmetric(lg[:, -1, :jcfgs[m].vocab_size],
                                         axis=-1)
        out = out + w * np.asarray(scale)
    return out


def assert_int8_close(Y, Yj, steps):
    diff = np.abs(Y - Yj)
    assert (diff <= steps + 2e-5).all(), float((diff - steps).max())
    assert (diff > 2e-5).mean() <= 0.01, float((diff > 2e-5).mean())


def _both(ens2, A, X, members=None, **kw):
    """The same system and request on the port and on the JAX package ->
    (port Y, JAX Y)."""
    jcfgs, tcfgs, jparams, tparams = ens2
    with make_system(tcfgs, tparams, A, **kw) as s:
        Y = s.predict(X, members=members)
    with jax_system(jcfgs, jparams, A, **kw) as js:
        Yj = js.predict(X, members=members)
    return Y, Yj


# ---- bf16 members' params ----------------------------------------------------

def test_bf16_params_halve_bytes_and_track(ens2):
    """test_quantized.py::test_bf16_params_halve_bytes_and_track: bf16
    storage is under 0.6 of fp32 with the JAX package's byte count, and
    every leaf comes back within 1 % of its scale, equal to the JAX
    package's round trip."""
    from repro_torch.kernels import quant as tq
    _, _, jparams, tparams = ens2
    jp, tp = jparams[0], tparams[0]
    fp32_bytes = sum(x.size * 4 for x in jax.tree_util.tree_leaves(jp))
    nbytes = tq.quantized_param_bytes(tp, "bf16")
    assert nbytes == jq.quantized_param_bytes(jp, "bf16")
    assert nbytes < 0.6 * fp32_bytes
    back = []
    tq.tree_map(back.append, tq.dequantize_params(tq.quantize_params(tp,
                                                                     "bf16")))
    jback = jax.tree_util.tree_leaves(jq.dequantize_params(
        jq.quantize_params(jp, "bf16")))
    for a, b, j in zip(jax.tree_util.tree_leaves(jp), back, jback):
        a = np.asarray(a)
        scale = float(np.abs(a).max()) or 1.0
        assert float(np.abs(a - b.numpy()).max()) < 0.01 * scale
        np.testing.assert_array_equal(b.numpy(), np.asarray(j))


# ---- end-to-end: quantized system vs fp32 reference --------------------------

def test_int8_system_tracks_fp32(ens2):
    """test_quantized.py::test_int8_system_tracks_fp32."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(70)
    with make_system(tcfgs, tparams, [[8, 16]], segment_size=32) as s:
        Yref = s.predict(X)
    np.testing.assert_allclose(Yref, oracle(jcfgs, jparams, X), atol=2e-5)
    Y, Yj = _both(ens2, [[8, 16]], X, segment_size=32,
                  member_dtypes=["int8", "int8"])
    assert Y.shape == Yref.shape
    assert _rel_err(Y, Yref) < 0.05
    assert_int8_close(Y, Yj, int8_steps(jcfgs, jparams, X, {0: .5, 1: .5}))


@pytest.mark.parametrize("combine", ["pallas", "weighted"])
def test_int8_combine_rules_track_fp32(ens2, combine):
    """test_quantized.py::test_int8_combine_rules_track_fp32."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(40, seed=3)
    w = np.array([0.7, 0.3], np.float32) if combine == "weighted" else None
    kw = dict(segment_size=16, combine=combine)
    if w is not None:
        kw["weights"] = w
    with make_system(tcfgs, tparams, [[8, 8]], **kw) as s:
        Yref = s.predict(X)
    np.testing.assert_allclose(Yref, oracle(jcfgs, jparams, X, weights=w),
                               atol=2e-5)
    Y, Yj = _both(ens2, [[8, 8]], X, member_dtypes=["int8", "int8"], **kw)
    assert _rel_err(Y, Yref) < 0.05
    ws = {0: 0.7, 1: 0.3} if w is not None else {0: 0.5, 1: 0.5}
    assert_int8_close(Y, Yj, int8_steps(jcfgs, jparams, X, ws))


def test_int8_vote_matches_fp32_argmax(ens2):
    """test_quantized.py::test_int8_vote_matches_fp32_argmax: votes on the
    int8 logits stay normalized and nearly all rows vote as fp32 does; the
    port's int8 votes are the JAX system's, row for row."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(24, seed=4)
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16,
                     combine="vote") as s:
        Yref = s.predict(X)
    Y, Yj = _both(ens2, [[8, 8]], X, segment_size=16, combine="vote",
                  member_dtypes=["int8", "int8"])
    np.testing.assert_allclose(Y.sum(axis=1), 1.0, atol=1e-6)
    agree = (np.abs(Y - Yref).max(axis=1) < 1e-6).mean()
    assert agree >= 0.9, f"vote agreement {agree:.2f}"
    np.testing.assert_allclose(Y, Yj, atol=1e-6)


def test_int8_member_subsets_track_fp32(ens2):
    """test_quantized.py::test_int8_member_subsets_track_fp32."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(20, seed=5)
    kw = dict(segment_size=16, member_dtypes=["int8", "int8"])
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16) as sref, \
            make_system(tcfgs, tparams, [[8, 8]], **kw) as s, \
            jax_system(jcfgs, jparams, [[8, 8]], **kw) as js:
        for members in ([0], [1], [0, 1]):
            Y = s.predict(X, members=members)
            Yref = sref.predict(X, members=members)
            assert _rel_err(Y, Yref) < 0.05, members
            np.testing.assert_allclose(
                Yref, oracle(jcfgs, jparams, X, members), atol=2e-5)
            assert_int8_close(Y, js.predict(X, members=members), int8_steps(
                jcfgs, jparams, X, {m: 1 / len(members) for m in members}))


def test_int8_host_combine_path(ens2):
    """test_quantized.py::test_int8_host_combine_path: with
    device_combine=False the workers ship fp32 logits of the int8 params
    (no logit quantization), so the port and the JAX system agree at
    2e-5."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(30, seed=6)
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16,
                     device_combine=False) as s:
        Yref = s.predict(X)
    Y, Yj = _both(ens2, [[8, 8]], X, segment_size=16, device_combine=False,
                  member_dtypes=["int8", "int8"])
    assert _rel_err(Y, Yref) < 0.05
    np.testing.assert_allclose(Y, Yj, atol=2e-5)


def test_mixed_precision_ensemble(ens2):
    """test_quantized.py::test_mixed_precision_ensemble: int8 and fp32
    members fold into one partial."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(40, seed=8)
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16) as s:
        Yref = s.predict(X)
    Y, Yj = _both(ens2, [[8, 8]], X, segment_size=16,
                  member_dtypes=["int8", "fp32"])
    assert _rel_err(Y, Yref) < 0.05
    assert_int8_close(Y, Yj, int8_steps(jcfgs, jparams, X, {0: 0.5}))


# ---- precision-floor routing -------------------------------------------------

def test_precision_floor_filters_members(ens2):
    """test_quantized.py::test_precision_floor_filters_members: an fp32
    floor serves the fp32 member alone (the JAX forward's answer), an int8
    floor everyone, and no member at the floor raises."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(20, seed=10)
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16,
                     member_dtypes=["int8", "fp32"]) as s:
        y_fp32 = s.predict(X, options=PredictOptions(member_dtype="fp32"))
        y_m1 = s.predict(X, members=[1])
        np.testing.assert_allclose(y_fp32, y_m1, atol=1e-6)
        np.testing.assert_allclose(y_fp32, oracle(jcfgs, jparams, X, [1]),
                                   atol=2e-5)
        y_all = s.predict(X, options=PredictOptions(member_dtype="int8"))
        assert y_all.shape == y_fp32.shape
        assert np.abs(y_all - y_fp32).max() > 1e-4      # member 0 counted
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16,
                     member_dtypes=["int8", "int8"]) as s:
        with pytest.raises(MemberUnavailable):
            s.predict(X, options=PredictOptions(member_dtype="fp32"))


# ---- dtype-aware allocator ---------------------------------------------------

def test_worker_bytes_dtype_aware():
    """test_quantized.py::test_worker_bytes_dtype_aware, each footprint
    equal to the JAX package's."""
    cfg, jcfg = ensemble("ENS4")[0], jensemble("ENS4")[0]
    b32 = mem.worker_bytes(cfg, 8, 128)
    b8 = mem.worker_bytes(cfg, 8, 128, member_dtype="int8")
    bb = mem.worker_bytes(cfg, 8, 128, member_dtype="bf16")
    assert (b32, b8, bb) == (
        jmem.worker_bytes(jcfg, 8, 128),
        jmem.worker_bytes(jcfg, 8, 128, member_dtype="int8"),
        jmem.worker_bytes(jcfg, 8, 128, member_dtype="bf16"))
    assert b8 < b32 and bb < b32
    p32 = cfg.param_count() * 4
    assert b32 - b8 > 0.70 * p32
    assert abs((b32 - bb) - 0.5 * p32) < 0.01 * p32


def test_quantized_members_double_packing_density():
    """test_quantized.py::test_quantized_members_double_packing_density: a
    budget that cannot hold ENS4 at fp32 holds all of it at int8, with the
    JAX package's placement."""
    from repro_torch.core.worst_fit import AllocationError
    cfgs, jcfgs = ensemble("ENS4"), jensemble("ENS4")
    dts = ["int8"] * len(cfgs)
    f32 = sum(mem.worker_bytes(c, 8, SEQ) for c in cfgs)
    f8 = sum(mem.worker_bytes(c, 8, SEQ, member_dtype="int8") for c in cfgs)
    assert f8 < 0.5 * f32
    devs = host_cpus(1, memory_bytes=int(0.5 * f32))
    with pytest.raises(AllocationError):
        worst_fit_decreasing(cfgs, devs, seq=SEQ)
    a8 = worst_fit_decreasing(cfgs, devs, seq=SEQ, member_dtypes=dts)
    assert int((a8.A > 0).sum()) == len(cfgs)
    assert mem.fit_mem(a8, cfgs, SEQ, member_dtypes=dts)
    ja8 = jwfd(jcfgs, jhost_cpus(1, memory_bytes=int(0.5 * f32)), seq=SEQ,
               member_dtypes=dts)
    np.testing.assert_array_equal(a8.A, ja8.A)


# ---- live EDF dispatch queue -------------------------------------------------

def test_dispatch_queue_selection(ens2):
    """test_quantized.py::test_dispatch_queue_selection."""
    jcfgs, tcfgs, jparams, tparams = ens2
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16) as s:
        assert all(type(w._dispatch_q) is DispatchQueue for w in s.workers)
    X = _X(40, seed=11)
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16,
                     dispatch_queue="edf") as s:
        assert all(isinstance(w._dispatch_q, EDFDispatchQueue)
                   for w in s.workers)
        Y = s.predict(X)
    assert Y.shape == (40, tcfgs[0].vocab_size)
    np.testing.assert_allclose(Y, oracle(jcfgs, jparams, X), atol=2e-5)
    with pytest.raises(ValueError):
        make_system(tcfgs, tparams, [[8, 8]], dispatch_queue="lifo")


def test_edf_queue_matches_fifo_results(ens2):
    """test_quantized.py::test_edf_queue_matches_fifo_results: EDF only
    reorders dispatch."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(64, seed=12)
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16) as s:
        Yref = s.predict(X)
    with make_system(tcfgs, tparams, [[8, 8]], segment_size=16,
                     dispatch_queue="edf") as s:
        Y = s.predict(X)
    np.testing.assert_allclose(Y, Yref, atol=1e-5)
    np.testing.assert_allclose(Y, oracle(jcfgs, jparams, X), atol=2e-5)


def test_member_dtypes_validation(ens2):
    """test_quantized.py::test_member_dtypes_validation."""
    _, tcfgs, _, tparams = ens2
    with pytest.raises(ValueError):
        make_system(tcfgs, tparams, [[8, 8]], member_dtypes=["int8"])
    with pytest.raises(ValueError):
        make_system(tcfgs, tparams, [[8, 8]], member_dtypes=["int4", "fp32"])


# ---- chaos band: determinism within a precision mode -------------------------

@pytest.mark.chaos
def test_int8_chunk_replay_bit_identical(ens2):
    """test_quantized.py::test_int8_chunk_replay_bit_identical: a replay
    after a sibling's crash re-runs the same int8 member at the same shape,
    so the answers are those of a fault-free int8 run, bit for bit."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    _, tcfgs, _, tparams = ens2
    A = [[8, 8], [8, 0]]
    Xs = [_X(8, seed=i) for i in range(8)]

    def run(fault_plan):
        s = make_system(tcfgs, tparams, A, segment_size=8, watchdog_s=60.0,
                        supervise=True, supervise_interval_s=0.02,
                        member_dtypes=["int8", "int8"],
                        fault_plan=fault_plan)
        try:
            hs = [s.predict_async(x) for x in Xs]
            return [np.array(h.result(120.0)) for h in hs], \
                [h.quality for h in hs], s.serving_counters()
        finally:
            s.shutdown()

    base, _, _ = run(None)
    fp = FaultPlan(FaultSpec(stage="predictor", kind="raise", after=1,
                             worker="w1.0"))
    faulted, quals, counters = run(fp)
    assert all(q == 1.0 for q in quals)
    assert counters.get("quarantines") == 1
    for i, (yb, yf) in enumerate(zip(base, faulted)):
        np.testing.assert_array_equal(yb, yf, err_msg=f"request {i}")


@pytest.mark.chaos
def test_int8_midflight_demotion_matches_direct_subset(ens2):
    """test_quantized.py::test_int8_midflight_demotion_matches_direct_subset:
    demoting member 1 mid-flight equals asking for members=[0] up front,
    both on the int8 path."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    _, tcfgs, _, tparams = ens2
    fp = FaultPlan(FaultSpec(stage="predictor", kind="slow", stall_s=0.05,
                             repeat=True, worker="w1"))
    s = make_system(tcfgs, tparams, [[8, 8]], supervise=True,
                    member_dtypes=["int8", "int8"], fault_plan=fp)
    try:
        X = _X(64, seed=13)
        Yref = s.predict(X, members=[0], timeout=60.0)
        h = s.predict_async(X)
        assert s.demote_request(h.req.rid, {0})
        Y = h.result(60.0)
        assert np.allclose(Y, Yref, atol=1e-5)
        assert h.quality < 1.0
        assert s.serving_counters().get("requests_demoted") == 1
    finally:
        s.shutdown()


# ---- the int8 KV cache's bytes ---------------------------------------------

def test_quantized_cache_halves_bytes():
    """test_kv_quant.py::test_quantized_cache_halves_bytes: qwen3-1.7b's
    int8 cache at batch 128 and 32768 positions is under 0.6 of the bf16
    cache, with the JAX package's shapes, dtypes and bytes."""
    from repro.models.cache import layer_cache_struct as jlayer_cache_struct
    from repro_torch.models.cache import layer_cache_struct
    cfg, jcfg = get_config("qwen3-1.7b"), jget_config("qwen3-1.7b")
    f32b = cfg.kv_cache_bytes(128, 32768, 2)          # bf16 cache
    assert f32b == jcfg.kv_cache_bytes(128, 32768, 2)
    q = layer_cache_struct(cfg, "attn", 128, 32768, quantized=True)
    jqs = jlayer_cache_struct(jcfg, "attn", 128, 32768, quantized=True)
    assert {k: tuple(sh) for k, (sh, _) in q.items()} == \
        {k: tuple(sh) for k, (sh, _) in jqs.items()}
    qbytes = sum(int(np.prod(sh)) * dt.itemsize
                 for sh, dt in q.values()) * cfg.num_layers
    jbytes = sum(int(np.prod(sh)) * (1 if dt == jnp.int8 else 4)
                 for sh, dt in jqs.values()) * jcfg.num_layers
    assert qbytes == jbytes
    assert qbytes < 0.6 * f32b
