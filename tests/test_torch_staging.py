"""The predictor's double-buffered H2D staging and ``Model`` in the PyTorch
port, against the JAX package.

After a round commits chunk i, the predictor starts chunk i+1's upload at
once (``src/repro/serving/worker.py``'s staging); a staged upload is used
only by the chunk it was made for, and ``h2d_staged`` counts each one used.
On the CPU the upload aliases the ring slot, as JAX's ``device_put`` may
alias host memory, so the staging runs and counts here too."""
import threading
import time

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
from repro.serving.system import InferenceSystem as JInferenceSystem  # noqa: E402
from repro_torch.configs import ensemble, get_config  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.serving import InferenceSystem  # noqa: E402
from repro_torch.serving.worker import RING_SLOTS, Worker  # noqa: E402

SEQ = 16


@pytest.fixture(scope="module")
def ens2():
    """tests/test_quantized.py's ens2 (ENS4[:2] from PRNGKey(0)) in both
    packages, the port's on the JAX parameters bridged."""
    jcfgs = jensemble("ENS4")[:2]
    rng = jax.random.PRNGKey(0)
    jparams = [M.init_params(jax.random.fold_in(rng, i), c)
               for i, c in enumerate(jcfgs)]
    tparams = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
               for p in jparams]
    return jcfgs, ensemble("ENS4")[:2], jparams, tparams


def _X(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, SEQ)
                                                ).astype(np.int32)


def _system(pkg_cpus, pkg_alloc, pkg_system, cfgs, params, A, **kw):
    A = np.array(A)
    devs = pkg_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    return pkg_system(cfgs, params,
                      pkg_alloc(devs, [c.name for c in cfgs], A),
                      max_seq=SEQ, **kw)


def _staged(system) -> int:
    return sum(w.timers.counters.get("h2d_staged", 0) for w in system.workers)


def oracle(cfgs, params, X, members=None):
    """tests/test_serving.py's oracle: the JAX forwards of ``members``
    combined by their mean, in numpy."""
    members = list(range(len(cfgs))) if members is None else members
    out = np.zeros((X.shape[0], cfgs[0].vocab_size), np.float32)
    for i in members:
        lg, _ = M.forward(params[i], cfgs[i], jnp.asarray(X))
        out += np.asarray(lg[:, -1, :cfgs[i].vocab_size]) / len(members)
    return out


def test_h2d_staging_counter_matches_jax(ens2):
    """tests/test_quantized.py::test_h2d_staging_counter in both packages:
    multi-chunk segments drive the staging in each, and the answers agree."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(128, seed=9)
    with _system(jhost_cpus, JAllocationMatrix, JInferenceSystem, jcfgs,
                 jparams, [[8, 8]], segment_size=64) as s:
        Yj = s.predict(X)
        staged_jax = _staged(s)
    with _system(host_cpus, AllocationMatrix, InferenceSystem, tcfgs,
                 tparams, [[8, 8]], segment_size=64) as s:
        Y = s.predict(X)
        staged = _staged(s)
    assert Y.shape == (128, tcfgs[0].vocab_size)
    np.testing.assert_allclose(Y, Yj, atol=2e-5)
    assert staged_jax > 0 and staged > 0


@pytest.mark.parametrize("when", ["before_staging", "after_staging"])
def test_midround_demotion_restages(ens2, monkeypatch, when):
    """Four one-chunk requests A, B, C, D reach member 1's predictor in one
    round; B is demoted mid-round, either during A's forward (before
    anything is staged: the staging passes over B) or just after B's upload
    was staged (the staged buffer is then never used, and C uploads
    again).  No chunk is uploaded twice, ``h2d_staged`` counts each staged
    upload that a forward used once, B's answer is member 0's alone, and
    every ring slot comes back."""
    jcfgs, tcfgs, jparams, tparams = ens2
    # both predictors wait; member 1's round runs alone, so the counter
    # (shared by the system's workers) moves for it only
    release = [threading.Event(), threading.Event()]
    stall = Worker._predictor

    def stalled(self):
        release[self.model_idx].wait(60.0)
        return stall(self)

    def slots_back(wk):
        deadline = time.perf_counter() + 30.0
        while wk._free_slots.qsize() < RING_SLOTS:
            assert time.perf_counter() < deadline, "slot leaked"
            time.sleep(0.005)

    monkeypatch.setattr(Worker, "_predictor", stalled)
    Xs = [_X(8, seed=20 + i) for i in range(4)]
    s = _system(host_cpus, AllocationMatrix, InferenceSystem, tcfgs, tparams,
                [[8, 8]], segment_size=8, coalesce=False, dispatch_ahead=4)
    try:
        w = [w for w in s.workers if w.model_idx == 1][0]
        hs = [s.predict_async(X) for X in Xs]
        rid = {h.req.rid: i for i, h in enumerate(hs)}
        deadline = time.perf_counter() + 30.0
        while w.dispatch_backlog() < 4:        # A..D flushed, queued
            assert time.perf_counter() < deadline
            time.sleep(0.002)
        uploads, staged, forwards = [], [], []
        upload, stage, predict = w._upload, w._stage, w.predict_fn

        def demote_b():
            assert s.demote_request(hs[1].req.rid, {0})

        def counted_upload(c):
            uploads.append(rid[c.spans[0].req.rid])
            return upload(c)

        def counted_stage(c):
            out = stage(c)
            staged.append(rid[c.spans[0].req.rid])
            if when == "after_staging" and staged[-1] == 1:
                demote_b()
            return out

        def counted_predict(params, x, fe):
            rows = x.numpy()
            forwards.append([i for i, X in enumerate(Xs)
                             if np.array_equal(rows[:8], X)][0])
            if when == "before_staging" and len(forwards) == 1:
                demote_b()
            return predict(params, x, fe)

        w._upload, w._stage = counted_upload, counted_stage
        w.predict_fn = counted_predict
        before = s.timers.counters.get("h2d_staged", 0)
        release[1].set()
        slots_back(w)
        used = s.timers.counters.get("h2d_staged", 0) - before
        release[0].set()
        Ys = [h.result(60.0) for h in hs]
        assert forwards == [0, 2, 3]
        if when == "before_staging":
            assert staged == [2, 3] and uploads == [0, 2, 3] and used == 2
        else:
            assert staged == [1, 3] and uploads == [0, 1, 2, 3] and used == 1
        assert hs[1].quality < 1.0
        np.testing.assert_allclose(
            Ys[1], s.predict(Xs[1], members=[0], timeout=60.0), atol=1e-5)
        np.testing.assert_allclose(Ys[1], oracle(jcfgs, jparams, Xs[1], [0]),
                                   atol=2e-5)
        for i in (0, 2, 3):
            np.testing.assert_allclose(Ys[i], oracle(jcfgs, jparams, Xs[i]),
                                       atol=2e-5)
        for wk in s.workers:
            slots_back(wk)
    finally:
        for ev in release:
            ev.set()
        s.shutdown()


def test_model_matches_jax():
    """``Model(cfg)(params, tokens)`` on bridged parameters, reduced qwen3,
    at tests/test_torch_models.py's tolerance; ``forward_fn`` is the same
    forward, and ``init`` builds the parameter tree on the asked device."""
    jcfg = jget_config("qwen3-1.7b").reduced()
    tcfg = get_config("qwen3-1.7b").reduced()
    jmodel = M.Model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    X = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, SEQ)
                                          ).astype(np.int32)
    want, _ = jmodel(jparams, jnp.asarray(X))
    model = Model(tcfg)
    got, aux = model(tparams, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(aux) == 0.0
    again, _ = model.forward_fn()(tparams, tokens=torch.from_numpy(X))
    assert torch.equal(again, got)
    p = model.init(0, device="cpu")
    assert tq.tree_map(lambda t: (tuple(t.shape), t.device.type, t.dtype),
                       p) == tq.tree_map(
        lambda s: (tuple(s), "cpu", torch.float32), param_shapes(tcfg))
