"""The overload suite against the PyTorch port, ported from tests/test_overload.py,
plus the tier table's and member costs' parity with the JAX package.

Overload robustness suite (DESIGN.md §11): brownout levels, cost-aware
admission, backpressure and the confidence-gated cascade.

Fast tests (tier-1) run against fake-device systems or pure logic:
hysteresis cannot flap, infeasible deadlines 429 fast with a computed
Retry-After, the byte budget bounds admission, and degraded results cannot
poison the full-quality cache key space.

``chaos``-marked tests use real (tiny) models so output *values* matter:
mid-flight demotion must match a directly-requested member subset, the
cascade must reconstruct the full-ensemble combine, level 0 must be
bit-identical to an uncontrolled system, and brownout must compose with
worker quarantine/replay without losing a single request.
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
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.admission import AdmissionBudget  # noqa: E402
from repro_torch.serving.client import (_retry_after_of,  # noqa: E402
                                        quality_salt)
from repro_torch.serving.control.overload import (  # noqa: E402
    BrownoutController, build_tier_table, estimate_drain_s)
from repro_torch.serving.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serving.request_cache import PredictionCache  # noqa: E402
from repro_torch.serving.segments import (Overloaded,  # noqa: E402
                                          PredictOptions)
from repro_torch.serving.server import _header_s  # noqa: E402

SEQ = 16


def _X(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 64, (n, SEQ)).astype(np.int32)


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
    from repro_torch.core.allocation import AllocationMatrix
    from repro_torch.core.devices import host_cpus
    from repro_torch.serving.system import InferenceSystem
    A = np.array(A)
    devs = host_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs], A)
    kw.setdefault("max_seq", SEQ)
    return InferenceSystem(cfgs, params, alloc, **kw)


# ---- pure logic -------------------------------------------------------------

def test_tier_table_drops_worst_cost_per_weight():
    # member 1 is expensive per unit weight, member 2 cheap: 1 goes first,
    # the cheapest-per-weight member (2) survives to the last tier
    tiers = build_tier_table(np.array([0.5, 0.3, 0.2], np.float32),
                             [1.0, 2.0, 0.1])
    assert tiers[0] == (0, 1, 2)
    assert tiers[1] == (0, 2)
    assert tiers[-1] == (2,)


def test_retry_after_header_grammar():
    assert _header_s(0.05) == "1"        # integer seconds, never below 1
    assert _header_s(1.0) == "1"
    assert _header_s(1.2) == "2"


def test_client_retry_after_parsing():
    class E:
        headers = {"Retry-After": "3"}
    assert _retry_after_of(E(), '{"retry_after_s": 0.25}') == 0.25
    assert _retry_after_of(E(), "not json") == 3.0          # header fallback

    class E2:
        headers = {}
    assert _retry_after_of(E2(), "not json") is None


# ---- hysteresis -------------------------------------------------------------

def test_hysteresis_does_not_flap(ens2):
    cfgs, params = ens2
    s = make_system(cfgs, params, [[8, 8]], fake=True)
    try:
        ctl = BrownoutController(s, tiers=[(0, 1), (0,)],
                                 high=1.0, low=0.4, up_ticks=2, down_ticks=3,
                                 demote_inflight=False, feasibility=False)
        # oscillating around the high threshold: the consecutive-tick
        # counter resets every dip, so the level must hold at 0
        for _ in range(10):
            ctl.step(1.05)
            ctl.step(0.95)
        assert ctl.level == 0 and ctl.transitions == 0
        # sustained overload: exactly up_ticks ticks raise the level
        ctl.step(1.5)
        assert ctl.level == 0
        ctl.step(1.5)
        assert ctl.level == 1
        # oscillating around the low threshold: still no flap downward
        for _ in range(10):
            ctl.step(0.45)
            ctl.step(0.35)
        assert ctl.level == 1
        # inside the dead band: hold
        for _ in range(10):
            ctl.step(0.7)
        assert ctl.level == 1
        # sustained recovery: down_ticks consecutive quiet ticks step down
        for _ in range(3):
            ctl.step(0.1)
        assert ctl.level == 0
        assert ctl.transitions == 2
        assert s.serving_counters().get("brownout_transitions") == 2
    finally:
        s.shutdown()


def test_plan_members_level0_and_tiering(ens2):
    cfgs, params = ens2
    s = make_system(cfgs, params, [[8, 8]], fake=True)
    try:
        ctl = BrownoutController(s, tiers=[(0, 1), (0,)],
                                 demote_inflight=False, feasibility=False)
        opts = PredictOptions()
        # level 0: the exact input object comes back, quality 1.0
        members = [0, 1]
        kept, q = ctl.plan_members(members, opts)
        assert kept is members and q == 1.0
        ctl.step(2.0)
        ctl.step(2.0)
        assert ctl.level == 1
        kept, q = ctl.plan_members([0, 1], opts)
        assert kept == [0] and 0.0 < q < 1.0
        # high priority is never tier-planned
        kept, q = ctl.plan_members([0, 1], PredictOptions(priority="high"))
        assert kept == [0, 1] and q == 1.0
    finally:
        s.shutdown()


# ---- cost-aware admission + backpressure ------------------------------------

def test_infeasible_deadline_fails_fast_with_retry_after(ens2):
    cfgs, params = ens2
    # 5ms of simulated device time per chunk: a 1ms deadline is infeasible
    # even at zero backlog, so the rejection is deterministic
    s = make_system(cfgs, params, [[8, 8]], fake=True, fake_delay_us=5000)
    try:
        BrownoutController(s, tiers=[(0, 1), (0,)], demote_inflight=False)
        t0 = time.perf_counter()
        with pytest.raises(Overloaded) as ei:
            s.predict(_X(64), options=PredictOptions(deadline_ms=1.0))
        elapsed = time.perf_counter() - t0
        assert elapsed < 0.5                    # fail-fast, not a 504 later
        ra = ei.value.retry_after_s
        assert ra is not None and 0.0 < ra < 60.0
        assert s.serving_counters().get("admission_rejections") == 1
        # deadline-less and generously-deadlined requests still pass
        assert s.predict(_X(16), timeout=60.0).shape[0] == 16
        y = s.predict(_X(16), timeout=60.0,
                      options=PredictOptions(deadline_ms=30_000.0))
        assert y.shape[0] == 16
    finally:
        s.shutdown()


def test_byte_budget_backpressure(ens2):
    cfgs, params = ens2
    budget = AdmissionBudget(max_bytes=5000)    # one 64x16 int32 request
    s = make_system(cfgs, params, [[8, 8]], fake=True, fake_delay_us=20000,
                    admission_budget=budget)
    try:
        h1 = s.predict_async(_X(64))            # charges 64*16*4 = 4096 B
        assert budget.bytes_used == 4096
        with pytest.raises(Overloaded) as ei:
            s.predict_async(_X(64, seed=1))
        assert ei.value.retry_after_s is not None
        assert budget.rejected == 1
        assert h1.result(60.0).shape[0] == 64
        # completion credits the charge back (ownership transferred to the
        # request at submit); then admission opens again
        deadline = time.monotonic() + 5.0
        while budget.bytes_used and time.monotonic() < deadline:
            time.sleep(0.01)
        assert budget.bytes_used == 0
        assert s.predict(_X(8), timeout=60.0).shape[0] == 8
    finally:
        s.shutdown()


def test_budget_admits_oversized_request_when_idle():
    b = AdmissionBudget(max_bytes=100)
    assert b.try_charge(4096, 64)               # idle: never wedge a client
    assert not b.try_charge(1, 1)
    b.credit(4096, 64)
    assert b.bytes_used == 0


def test_drain_estimate_floor(ens2):
    cfgs, params = ens2
    s = make_system(cfgs, params, [[8, 8]], fake=True)
    try:
        assert estimate_drain_s(s) >= 0.05      # client backoff floor
        assert estimate_drain_s(s, floor_s=0.0) == 0.0   # idle, unfloored
        assert s.retry_after_s() >= 0.05
    finally:
        s.shutdown()


# ---- cache quality poisoning ------------------------------------------------

def test_degraded_results_cannot_poison_cache():
    assert quality_salt(b"s", 1.0) == b"s"      # full quality: unchanged key
    assert quality_salt(b"s", 0.5) != b"s"
    assert quality_salt(b"s", 0.5) != quality_salt(b"s", 0.25)
    cache = PredictionCache(16)
    X = _X(4)
    cache.insert(X, np.ones((4, 8), np.float32), quality_salt(b"s", 0.5))
    hits, misses = cache.lookup(X, b"s")
    assert len(misses) == 4                     # degraded entry never served
    hits, misses = cache.lookup(X, quality_salt(b"s", 0.5))
    assert not misses                           # same-tier lookups do hit


def test_predict_through_skips_insert_for_degraded_results():
    class _H:
        def __init__(self, q):
            self.quality = q

        def result(self, timeout=None):
            return np.zeros((4, 8), np.float32)

    class _Sys:
        def __init__(self, q):
            self.q = q

        def predict_async(self, X):
            return _H(self.q)

    cache = PredictionCache(16)
    cache.predict_through(_Sys(0.5), _X(4))
    assert len(cache._store) == 0               # degraded: not cached
    cache.predict_through(_Sys(1.0), _X(4))
    assert len(cache._store) == 4


# ---- real-model value consistency (chaos band) ------------------------------

@pytest.mark.chaos
def test_midflight_demotion_matches_direct_subset(ens2):
    """Demoting member 1 mid-flight must produce the same values as asking
    for members=[0] up front: forgiveness + renormalization, not zeros."""
    cfgs, params = ens2
    # sustained 'slow' fault holds member 1's predictor long enough for
    # the demotion to land before any of its chunks are forwarded
    fp = FaultPlan(FaultSpec(stage="predictor", kind="slow", stall_s=0.05,
                             repeat=True, worker="w1"))
    s = make_system(cfgs, params, [[8, 8]], fault_plan=fp)
    try:
        X = _X(64)
        Yref = s.predict(X, members=[0], timeout=60.0)
        h = s.predict_async(X)
        assert s.demote_request(h.req.rid, {0})
        Y = h.result(60.0)
        assert np.allclose(Y, Yref, atol=1e-5)
        assert h.quality < 1.0
        c = s.serving_counters()
        assert c.get("requests_demoted") == 1
        assert c.get("rows_demoted", 0) >= 64
    finally:
        s.shutdown()


@pytest.mark.chaos
def test_level0_bit_identical_and_cascade_restores_full_quality(ens2):
    cfgs, params = ens2
    s = make_system(cfgs, params, [[8, 8]])
    try:
        X = _X(48)
        Yref = s.predict(X, timeout=60.0)       # no controller attached
        ctl = BrownoutController(s, tiers=[(0, 1), (0,)],
                                 cascade_margin=float("inf"),
                                 demote_inflight=False, feasibility=False)
        # level 0 is a strict no-op: bit-identical, quality untouched
        h0 = s.predict_async(X)
        assert np.array_equal(h0.result(60.0), Yref)
        assert h0.quality == 1.0
        ctl.step(2.0)
        ctl.step(2.0)
        assert ctl.level == 1
        # margin threshold of +inf forces escalation: the cheap tier plus
        # the escalated members must reconstruct the full-ensemble combine
        h = s.predict_async(X)
        Y = h.result(60.0)
        assert np.allclose(Y, Yref, atol=1e-5)
        assert h.quality == 1.0
        assert s.serving_counters().get("cascade_escalations") == 1
    finally:
        s.shutdown()


@pytest.mark.chaos
def test_brownout_composes_with_supervision_zero_lost(ens2):
    """A worker crash (quarantine + replay) during an active brownout must
    still lose zero requests: every handle resolves with a quality-stamped
    result, never a hang or an untyped failure."""
    cfgs, params = ens2
    fp = FaultPlan(FaultSpec(stage="sender", kind="raise", after=2,
                             worker="w0.0"))
    s = make_system(cfgs, params, [[8, 8], [8, 0]], fake=True,
                    fake_delay_us=2000, fault_plan=fp,
                    supervise=True, supervise_interval_s=0.02)
    try:
        ctl = BrownoutController(s, tiers=[(0, 1), (0,)],
                                 demote_inflight=True, feasibility=False)
        hs = [s.predict_async(_X(48, seed=i)) for i in range(10)]
        ctl.step(2.0)
        ctl.step(2.0)                           # level 1: demote in flight
        assert ctl.level == 1
        for h in hs:
            y = h.result(60.0)
            assert y.shape == (48, cfgs[0].vocab_size)
            assert 0.0 < h.quality <= 1.0
        c = s.serving_counters()
        assert c.get("quarantines") == 1
        assert c.get("requests_demoted", 0) >= 1
        # and the system still serves after both events
        assert s.predict(_X(16), timeout=60.0).shape[0] == 16
    finally:
        s.shutdown()


# ---- parity with the JAX package --------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tier_table_matches_the_jax_package(seed):
    from repro.serving.control.overload import build_tier_table as jbuild
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 7))
    weights = rng.random(m).astype(np.float32)
    costs = list(rng.random(m) * 3.0)
    assert build_tier_table(weights, costs) == jbuild(weights, costs)


def test_member_costs_and_tiers_match_the_jax_package(ens2):
    """The same fake systems (an int8 member, per-worker simulated delays)
    and the same live readings give the same costs and tiers."""
    from repro.core.allocation import AllocationMatrix as JAllocationMatrix
    from repro.core.devices import host_cpus as jhost_cpus
    from repro.serving.control import LiveBench as JLiveBench
    from repro.serving.control.overload import BrownoutController as JBrown
    from repro.serving.system import InferenceSystem as JInferenceSystem
    from repro_torch.serving.control import LiveBench
    cfgs, params = ens2
    jcfgs, jparams = _jax_ens2()
    A = [[8, 16], [8, 0]]
    kw = dict(fake=True, fake_delay_us=700, member_dtypes=["fp32", "int8"],
              weights=np.array([0.7, 0.3], np.float32), combine="weighted",
              max_seq=SEQ)
    tsys = make_system(cfgs, params, A, **kw)
    jsys = JInferenceSystem(
        jcfgs, jparams, JAllocationMatrix(jhost_cpus(2, 8 * 1024 ** 3),
                                          [c.name for c in jcfgs],
                                          np.array(A)), **kw)
    out = []
    try:
        for s, Live, Brown in ((tsys, LiveBench, BrownoutController),
                               (jsys, JLiveBench, JBrown)):
            costs = [Brown(s).member_costs()]
            live = Live(s.cfgs, seq=SEQ)
            key = s.alloc.devices[1].key()
            live.observe(0, key, 8, 8, 0.003)  # member 0 measured on cell 1
            ctl = Brown(s, live=live)
            costs.append(ctl.member_costs())
            out.append((costs, ctl.tiers()))
    finally:
        tsys.shutdown()
        jsys.shutdown()
    (tcosts, ttiers), (jcosts, jtiers) = out
    for t, j in zip(tcosts, jcosts):
        np.testing.assert_allclose(t, j, rtol=1e-12)
    assert ttiers == jtiers
