"""Brownout demotion at each point of the pipeline, the port against the
JAX system.

Both packages serve tests/test_quantized.py's ens2 (ENS4[:2] from
PRNGKey(0), the port's on the JAX parameters bridged) with member 0 in
fp32 and member 1 in int8, both on one CPU cell behind its device
combiner, so member 1 forwards ``(q, per-row scale)`` logits that the
combiner dequantizes.  A request of 16 rows is two segments of 8, each
two of member 0's chunks of 4.  Member 0 is demoted (``demote_request``,
keeping member 1) or planned away at admission, at one of five points
forced by hooks the test owns (the stages' fault ticks, gates on the
batchers, the staged upload, the combiner's folds):

  (a) ``admission``: tier-planned to member 1 by a ``BrownoutController``
      held at level 1;
  (b) ``batcher``: before member 0's batcher admits either segment, with
      member 1 held back, so the combiner drops the expectation before
      member 1's rows arrive;
  (c) ``chunk``: at member 0's sender, between the two chunks of the
      second segment (its first chunk's rows staged), the first segment
      already folded;
  (d) ``staged``: just after the predictor staged the first segment's
      second chunk behind the first's forward, which then skips it;
  (e) ``partial``: with member 1's rows of both segments already in the
      partials when member 0's batcher forgives them and ``unexpect``
      flushes them.

At each point, under ``combine="weighted"`` (weights 0.7 / 0.3) and
``"mean"``, the port's ``Y`` is held to the JAX system's at atol 2e-5,
with the quality and the demotion counters equal, and each row to the
port's own answer from the members that served it.  The last test holds
``chip_smoke.py``'s reading of a drill to the JAX system: a drill whose
tier drops the int8 member serves member 0 alone, and the check holds
those rows to member 0 and the members each request kept to the tier
table."""
import functools
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.core import AllocationMatrix as JAllocationMatrix  # noqa: E402
from repro.core import host_cpus as jhost_cpus  # noqa: E402
from repro.serving.control.overload import (  # noqa: E402
    BrownoutController as JBrownoutController)
from repro.serving.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving.segments import FlushBarrier as JFlushBarrier  # noqa: E402
from repro.serving.system import InferenceSystem as JInferenceSystem  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceSystem  # noqa: E402
from repro_torch.serving.control.overload import (  # noqa: E402
    BrownoutController)
from repro_torch.serving.faults import FaultPlan  # noqa: E402
from repro_torch.serving.segments import FlushBarrier  # noqa: E402

SEQ, SEG, ROWS = 16, 8, 16
DRILL_ROWS = 16                      # a drill's request
A = [[4, 4]]                         # one cell: both members, batch 4
WEIGHTS = {"weighted": [0.7, 0.3], "mean": None}
POINTS = ("admission", "batcher", "chunk", "staged", "partial")
COUNTERS = ("requests_demoted", "members_demoted", "rows_demoted",
            "brownout_planned")
WAIT_S = 60.0


@functools.lru_cache(maxsize=None)
def ens2():
    jcfgs = jensemble("ENS4")[:2]
    rng = jax.random.PRNGKey(0)
    jparams = [M.init_params(jax.random.fold_in(rng, i), c)
               for i, c in enumerate(jcfgs)]
    tparams = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                 "cpu") for p in jparams]
    return jcfgs, ensemble("ENS4")[:2], jparams, tparams


def _X(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, SEQ)
                                                ).astype(np.int32)


def hook_plan(base):
    """A ``FaultPlan`` of ``base``'s package that fires no fault: it counts
    each (worker, stage) tick and runs the test's hook for the n-th."""

    class HookPlan(base):
        def __init__(self):
            super().__init__()
            self.hooks = {}
            self.n = {}

        def count(self, worker: str, stage: str) -> int:
            return self.n.get((worker, stage), 0)

        def at(self, worker: str, stage: str, n: int, fn) -> None:
            self.hooks[(worker, stage, n)] = fn

        def tick(self, worker_id, stage):
            key = (worker_id, stage)
            n = self.n.get(key, 0)
            self.n[key] = n + 1      # each (worker, stage): one thread
            fn = self.hooks.pop((worker_id, stage, n), None)
            if fn is not None:
                fn()
            return None

    return HookPlan()


class Gate:
    """Holds the thread that reaches it until released."""

    def __init__(self):
        self.reached, self.open = threading.Event(), threading.Event()

    def __call__(self):
        self.reached.set()
        assert self.open.wait(WAIT_S)


def until(cond, what: str) -> None:
    deadline = time.perf_counter() + WAIT_S
    while not cond():
        assert time.perf_counter() < deadline, what
        time.sleep(0.002)


class Window:
    """Stands in for a worker's dispatch-window semaphore: the predictor's
    blocking acquire, the first of a round, waits at ``gate``."""

    def __init__(self, sem):
        self.sem, self.gate = sem, Gate()

    def acquire(self, blocking=True):
        if blocking:
            self.gate()
        return self.sem.acquire(blocking)

    def release(self):
        self.sem.release()


def hold_round(worker, barrier_cls) -> Window:
    """Park ``worker``'s predictor at the top of a round with no window
    token taken: a barrier ends the round it waits in, and the next
    round's first acquire waits at the returned window's gate."""
    sem = worker._dispatch_sem
    window = Window(sem)
    worker._dispatch_sem = window
    barrier = barrier_cls()
    worker._dispatch_q.put(barrier)
    assert barrier.done.wait(WAIT_S)
    assert window.gate.reached.wait(WAIT_S)
    worker._dispatch_sem = sem
    return window


PACKAGES = {
    "jax": (jhost_cpus, JAllocationMatrix, JInferenceSystem, JFaultPlan,
            JBrownoutController, JFlushBarrier),
    "torch": (host_cpus, AllocationMatrix, InferenceSystem, FaultPlan,
              BrownoutController, FlushBarrier),
}


def serve_points(pkg: str, combine: str, monkeypatch) -> dict:
    """Each point on one system of package ``pkg``: {point: the demoted
    request's ``Y``, quality, members and forgiven rows, and the
    counters' growth}, the system's own answers for the same rows from
    both members and from member 1 alone, and (under ``mean``) a drill
    for either tier."""
    cpus, alloc_cls, system_cls, plan_cls, ctl_cls, barrier_cls = \
        PACKAGES[pkg]
    jcfgs, tcfgs, jparams, tparams = ens2()
    cfgs, params = (jcfgs, jparams) if pkg == "jax" else (tcfgs, tparams)
    plan = hook_plan(plan_cls)
    w = WEIGHTS[combine]
    system = system_cls(
        cfgs, params,
        alloc_cls(cpus(1, memory_bytes=8 * 1024 ** 3),
                  [c.name for c in cfgs], np.array(A)),
        max_seq=SEQ, segment_size=SEG, dispatch_ahead=2, combine=combine,
        weights=None if w is None else np.array(w, np.float32),
        member_dtypes=["fp32", "int8"], fault_plan=plan)
    X0, X1 = _X(SEG, seed=31), _X(ROWS, seed=32)
    out = {}
    try:
        (combiner,) = system.combiners.values()
        (w0,) = system.instances(0)
        adds = []
        fold = combiner.add

        def recorded(req, s, m, P, row_lo=0):
            fold(req, s, m, P, row_lo)
            adds.append((req.rid, s, m))

        combiner.add = recorded

        def demote(h, keep=1):
            assert system.demote_request(h.req.rid, {keep})

        def counters():
            c = system.serving_counters()
            return {k: c.get(k, 0) for k in COUNTERS}

        def gate_batcher(worker):
            g = Gate()
            plan.at(worker, "batcher", plan.count(worker, "batcher"), g)
            return g

        for point in POINTS:
            before = counters()
            if point == "admission":
                ctl = ctl_cls(system, tiers=[(0, 1), (1,)])
                ctl.step(2.0)
                ctl.step(2.0)
                assert ctl.level == 1
                h = system.predict_async(X1)
                system.brownout = None
            elif point in ("batcher", "partial"):
                # a one-segment request ahead holds the batchers at its
                # admission while the demoted request waits behind it
                g0 = gate_batcher("w0.0")
                g1 = gate_batcher("w0.1") if point == "batcher" else None
                h0 = system.predict_async(X0)
                assert g0.reached.wait(WAIT_S)
                h = system.predict_async(X1)
                if point == "partial":
                    until(lambda: {(h.req.rid, s, 1) for s in (0, 1)}
                          <= set(adds), "member 1's folds")
                demote(h)
                g0.open.set()
                if g1 is not None:
                    until(lambda: h.degraded_rows == ROWS,
                          "member 0's forgiveness")
                    g1.open.set()
                h0.result(WAIT_S)
            elif point == "chunk":
                n = plan.count("w0.0", "sender")
                hold = []
                plan.at("w0.0", "sender", n + 3, lambda: demote(hold[0]))
                hold.append(system.predict_async(X1))
                h = hold[0]
            else:                                   # staged
                # the predictor's next round takes both window tokens and
                # pops both chunks of the first segment, so it stages the
                # second behind the first's forward (a round that pops one
                # chunk stages nothing)
                window = hold_round(w0, barrier_cls)
                hold, calls = [], []
                if pkg == "torch":
                    stage = w0._stage

                    def staged_then_demoted(c):
                        got = stage(c)
                        if not calls:
                            calls.append(c)
                            demote(hold[0])
                        return got

                    w0._stage = staged_then_demoted
                else:
                    put = jax.device_put

                    def put_then_demote(x, *a, **k):
                        got = put(x, *a, **k)
                        if threading.current_thread().name == \
                                "w0.0-predictor" and \
                                isinstance(x, np.ndarray) and x.ndim == 2:
                            calls.append(x)
                            if len(calls) == 2:  # the staged second chunk
                                demote(hold[0])
                        return got

                    monkeypatch.setattr(jax, "device_put", put_then_demote)
                hold.append(system.predict_async(X1))
                h = hold[0]
                until(lambda: w0.dispatch_backlog() >= 2 and
                      w0._dispatch_sem._value == w0.dispatch_ahead,
                      "the first segment's chunks and a free window")
                window.gate.open.set()
            Y = h.result(WAIT_S)
            if point == "staged":
                if pkg == "torch":
                    w0._stage = stage
                else:
                    monkeypatch.undo()
            after = counters()
            missing = h._missing_w
            out[point] = {
                "Y": Y, "quality": h.quality,
                "members": sorted(h.req.members),
                "forgiven": None if missing is None else missing > 0,
                "counters": {k: after[k] - before[k] for k in COUNTERS}}
        out["full"] = system.predict(X1)
        out["alone"] = system.predict(X1, members=[1])
        if combine == "mean":
            # a drill as chip_smoke.py reads it: one request planned at
            # admission to the tier's member, one demoted to it mid-flight
            # at the other member's fourth chunk, for either tier
            XD = _X(2 * DRILL_ROWS, seed=33)
            out["drill_full"] = system.predict(XD)
            out["drill_members"] = [system.predict(XD, members=[m])
                                    for m in (0, 1)]
            for keep in (1, 0):
                ctl = ctl_cls(system, tiers=[(0, 1), (keep,)])
                ctl.step(2.0)
                ctl.step(2.0)
                planned = system.predict_async(XD[:DRILL_ROWS])
                system.brownout = None
                hold, drop = [], f"w0.{1 - keep}"
                plan.at(drop, "sender", plan.count(drop, "sender") + 3,
                        lambda hold=hold, keep=keep: demote(hold[0], keep))
                hold.append(system.predict_async(XD[DRILL_ROWS:]))
                hs = [planned, hold[0]]
                out[f"drill_keep_{keep}"] = {
                    "Ys": [h.result(WAIT_S) for h in hs], "handles": hs}
    finally:
        system.shutdown()
    return out


@functools.lru_cache(maxsize=None)
def _served(combine: str):
    mp = pytest.MonkeyPatch()
    try:
        return {pkg: serve_points(pkg, combine, mp) for pkg in PACKAGES}
    finally:
        mp.undo()


# the rows member 0 gave up at each point, and the demotion counters
EXPECTED = {
    "admission": (slice(0, ROWS), {"brownout_planned": 1}),
    "batcher": (slice(0, ROWS), {"requests_demoted": 1,
                                 "members_demoted": 1, "rows_demoted": 16}),
    "chunk": (slice(SEG, ROWS), {"requests_demoted": 1,
                                 "members_demoted": 1, "rows_demoted": 4}),
    "staged": (slice(0, ROWS), {"requests_demoted": 1,
                                "members_demoted": 1, "rows_demoted": 16}),
    "partial": (slice(0, ROWS), {"requests_demoted": 1,
                                 "members_demoted": 1, "rows_demoted": 16}),
}


@pytest.mark.parametrize("combine", ["weighted", "mean"])
@pytest.mark.parametrize("point", POINTS)
def test_demotion_point_matches_jax(point, combine):
    served = _served(combine)
    got, want = served["torch"][point], served["jax"][point]
    np.testing.assert_allclose(got["Y"], want["Y"], atol=2e-5)
    assert got["quality"] == pytest.approx(want["quality"], abs=1e-12)
    assert got["counters"] == want["counters"]
    rows, counts = EXPECTED[point]
    assert got["counters"] == {k: counts.get(k, 0) for k in COUNTERS}
    w = WEIGHTS[combine] or [0.5, 0.5]
    lost = rows.stop - rows.start
    tier = w[1] / sum(w) if point == "admission" else 1.0
    assert got["quality"] == pytest.approx(
        tier * (1.0 - (0 if point == "admission" else lost) / (2 * ROWS)))
    # each row is the port's own answer from the members that served it
    alone = np.zeros(ROWS, bool)
    alone[rows] = True
    if point == "admission":
        assert got["members"] == [1] and got["forgiven"] is None
    else:
        assert got["members"] == [0, 1]
        np.testing.assert_array_equal(got["forgiven"], alone)
    port = served["torch"]
    np.testing.assert_allclose(got["Y"][alone], port["alone"][alone],
                               atol=1e-6)
    np.testing.assert_allclose(got["Y"][~alone], port["full"][~alone],
                               atol=1e-6)


def jax_drill_reference(served):
    """``chip_smoke.py``'s reference for a drill's rows, from the JAX
    system's answers of each member alone: ((member 0's logits, member
    1's int8 logits dequantized), member 1's row scales (its largest
    logit maps to code 127), the drill's weights), and member 1's logits
    for the miss report's unquantized column (here the dequantized
    ones)."""
    P0, P1 = served["jax"]["drill_members"]
    return ([P0, P1], np.abs(P1).max(axis=1) / 127.0, [0.5, 0.5]), P1


@pytest.mark.parametrize("keep", [1, 0])
def test_drill_reading_matches_the_jax_system(keep):
    """A drill whose tier keeps member ``keep``: one request planned to it
    at admission, one demoted to it mid-flight after its first segment.
    Both packages serve the same answers, and ``chip_smoke.py``'s check
    holds every row to the members that served it and passes on both.
    The check also holds the members each request kept to the tier table:
    a record whose tier names the other member misses, and so does a
    tier priced from member costs that make the kept member the dearer
    per combine weight."""
    served = _served("mean")
    ref, raw1 = jax_drill_reference(served)
    alone = {1: "rows_int8_alone", 0: "rows_fp32_alone"}[keep]
    for pkg in PACKAGES:
        d = served[pkg][f"drill_keep_{keep}"]
        run = {"Y_warm": served[pkg]["drill_full"],
               "Y_full": served[pkg]["drill_full"], "Ys": d["Ys"],
               "rows": DRILL_ROWS,
               "served": [chip_smoke.served_record(h) for h in d["handles"]],
               "by_sender": None, "tiers_given": True, "member_costs": [],
               "counters": {},
               "brownout": {"tiers": [[0, 1], [keep]], "level": 1}}
        verdict = chip_smoke.drill_verdict(run, ref, raw1)
        assert verdict["ok"], (pkg, verdict["miss"])
        assert verdict["groups"] == {alone: 2 * DRILL_ROWS - SEG,
                                     "rows_full": SEG}
        cost = [1.0, 1.0]
        cost[1 - keep] = 2.0                 # the dropped member dearer
        priced = {**run, "tiers_given": False, "member_costs": cost}
        assert chip_smoke.drill_verdict(priced, ref, raw1)["ok"]
        dear = {**priced, "member_costs": cost[::-1]}
        assert "least cost per weight" in \
            chip_smoke.drill_verdict(dear, ref, raw1)["miss"]
        other = {**run, "brownout": {"tiers": [[0, 1], [1 - keep]],
                                     "level": 1}}
        miss = chip_smoke.drill_verdict(other, ref, raw1)["miss"]
        assert f"kept members [{keep}]" in miss
    # a logit on an int8 rounding edge may take the next code in one
    # package: tests/test_torch_quantized_system.py's rule
    Y, Yj = (np.concatenate(served[pkg][f"drill_keep_{keep}"]["Ys"])
             for pkg in ("torch", "jax"))
    w1 = np.full(2 * DRILL_ROWS, float(keep))     # member 1's weight
    w1[DRILL_ROWS:DRILL_ROWS + SEG] = 0.5
    steps = (w1 * ref[1])[:, None]
    diff = np.abs(Y - Yj)
    assert (diff <= steps + 2e-5).all(), float((diff - steps).max())
    assert (diff > 2e-5).mean() <= 0.01
