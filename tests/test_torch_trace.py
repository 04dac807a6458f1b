"""Request traces in the PyTorch port, ported from the ``TraceRecorder``
cases of tests/test_sim.py, plus the JSON lines' compatibility with the JAX
package's in both directions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.trace import (TraceEvent, TraceRecorder,  # noqa: E402
                                       load_trace, save_trace)

SEQ = 16
GiB = 1024 ** 3


# ---- trace schema ------------------------------------------------------------

def test_trace_event_json_roundtrip():
    evs = [TraceEvent(t=0.125, rows=64, priority="high", deadline_ms=50.0,
                      members=(0, 2)),
           TraceEvent(t=0.25, rows=1)]   # None deadline / members survive
    for ev in evs:
        assert TraceEvent.from_json(ev.to_json()) == ev


def test_trace_recorder_roundtrip(tmp_path):
    rec = TraceRecorder()
    rec.record(8, t=0.2, priority="normal")
    rec.record(64, t=0.0, priority="high", deadline_ms=10.0, members=[1])
    path = str(tmp_path / "t.jsonl")
    assert rec.save(path) == 2
    evs = load_trace(path)
    assert [e.t for e in evs] == [0.0, 0.2]       # sorted on load
    assert evs[0].members == (1,) and evs[0].deadline_ms == 10.0
    assert evs[1].members is None and evs[1].priority == "normal"


# ---- across the two packages -------------------------------------------------

def _record(recorder_cls):
    rec = recorder_cls()
    rec.record(8, t=0.2, priority="normal")
    rec.record(64, t=0.0, priority="high", deadline_ms=10.0, members=[1])
    rec.record(3, t=1 / 3, priority=0, deadline_ms=2.5, members=(0, 2))
    return rec


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_trace_loads_in_the_other_package(writer, tmp_path):
    """The JSON lines are byte for byte the JAX package's, and a trace
    written by either package loads in the other."""
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")}
    _record(TraceRecorder).save(paths["port"])
    _record(jtrace.TraceRecorder).save(paths["jax"])
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    reader = jtrace.load_trace if writer == "port" else load_trace
    evs = reader(paths[writer])
    assert [(e.t, e.rows, e.priority, e.deadline_ms, e.members)
            for e in evs] == [(0.0, 64, "high", 10.0, (1,)),
                              (0.2, 8, "normal", None, None),
                              (round(1 / 3, 9), 3, "high", 2.5, (0, 2))]


# ---- the live recorder hook ----------------------------------------------------

@pytest.fixture(scope="module")
def ens2():
    """The port's ENS4[:2] on the JAX package's parameters, bridged."""
    rng = jax.random.PRNGKey(0)
    return ensemble("ENS4")[:2], [
        params_from_numpy(jax.tree_util.tree_map(
            np.asarray, M.init_params(jax.random.fold_in(rng, i), c)), "cpu")
        for i, c in enumerate(jensemble("ENS4")[:2])]


def test_inference_system_records_offered_trace(ens2, tmp_path):
    from repro.serving.sim import ServiceModel, SimSystem, WorkerSpec
    from repro_torch.serving.segments import PredictOptions
    from repro_torch.serving.system import InferenceSystem
    cfgs, params = ens2
    devs = host_cpus(1, memory_bytes=8 * GiB)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs],
                             np.array([[16, 16]]))
    system = InferenceSystem(cfgs, params, alloc, max_seq=SEQ)
    rec = TraceRecorder()
    system.trace_recorder = rec
    try:
        X = np.zeros((3, SEQ), np.int32)
        system.predict(X, timeout=60.0)
        system.predict(X[:1], timeout=60.0,
                       options=PredictOptions(priority="high",
                                              deadline_ms=5e3, members=[1]))
    finally:
        system.shutdown()
    evs = rec.events()
    assert [(e.rows, e.priority, e.members) for e in evs] == \
        [(3, "normal", (0, 1)), (1, "high", (1,))]
    assert evs[1].deadline_ms == 5e3
    assert evs[0].t == 0.0 and evs[1].t >= 0.0
    path = str(tmp_path / "live.jsonl")
    save_trace(path, evs)
    # the JAX package's simulator replays the port's recorded trace as-is
    sim = SimSystem(ServiceModel.from_delays({0: 100, 1: 100}),
                    [WorkerSpec(0, 16), WorkerSpec(1, 16)],
                    segment_size=16).run(jtrace.load_trace(path))
    assert sim.results()["completed"] == 2
