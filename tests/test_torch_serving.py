"""The PyTorch port's ``InferenceSystem`` on the host CPU against the JAX
package: the oracle of tests/test_serving.py (each member's forward, combined
in numpy) and, for a quantized member, the JAX system itself.  Parameters
are the JAX package's, bridged through numpy."""
import dataclasses

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
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceSystem  # noqa: E402

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


def oracle(cfgs, params, X, weights=None):
    """tests/test_serving.py's oracle: JAX forwards combined in numpy."""
    w = weights if weights is not None else [1 / len(cfgs)] * len(cfgs)
    out = np.zeros((X.shape[0], cfgs[0].vocab_size), np.float32)
    for i, (c, p) in enumerate(zip(cfgs, params)):
        lg, _ = M.forward(p, c, jnp.asarray(X))
        out += np.asarray(lg[:, -1, :c.vocab_size]) * w[i]
    return out


def make_system(cfgs, params, A, **kw):
    A = np.array(A)
    devs = host_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [c.name for c in cfgs], A)
    return InferenceSystem(cfgs, params, alloc, max_seq=SEQ, **kw)


def _X(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, SEQ)
                                                ).astype(np.int32)


@pytest.mark.parametrize("combine", ["mean", "pallas"])
@pytest.mark.parametrize("A,segment_size", [([[8, 16]], 32),
                                            ([[8, 8], [16, 0]], 16)])
def test_predict_matches_jax_oracle(ens2, combine, A, segment_size):
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(70, seed=len(A))
    ops.reset_counts()
    with make_system(tcfgs, tparams, A, combine=combine, use_kernel=True,
                     segment_size=segment_size) as s:
        assert len(s.workers) == int((np.array(A) > 0).sum())
        Y = s.predict(X)
    np.testing.assert_allclose(Y, oracle(jcfgs, jparams, X), atol=2e-5)
    calls = ops.plain_calls()
    assert calls["flash_attention"] > 0
    # the pallas rule folds through the accumulate kernel's entry
    assert (calls["ensemble_accumulate"] > 0) == (combine == "pallas")


def test_host_combine_path_matches_jax_oracle(ens2):
    """device_combine=False: per-member messages, fused fresh combine in the
    accumulator on the system's device."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(40, seed=3)
    ops.reset_counts()
    with make_system(tcfgs, tparams, [[8, 8]], combine="pallas",
                     device_combine=False, segment_size=16) as s:
        Y = s.predict(X)
    np.testing.assert_allclose(Y, oracle(jcfgs, jparams, X), atol=2e-5)
    assert ops.plain_calls()["ensemble_combine"] > 0


def test_weighted_combine_matches_jax_oracle(ens2):
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(20, seed=4)
    w = np.array([0.8, 0.2], np.float32)
    with make_system(tcfgs, tparams, [[8, 8]], combine="weighted",
                     weights=w, segment_size=16) as s:
        Y = s.predict(X)
    np.testing.assert_allclose(Y, oracle(jcfgs, jparams, X, w), atol=2e-5)


def test_int8_member_matches_jax_system(ens2):
    """fp32 + int8 members under 'pallas' against the JAX system with the
    same settings.  Weight codes agree; a logit on an int8 rounding edge may
    flip one code between the two, so each row may differ by w·s_row."""
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(40, seed=5)
    kw = dict(segment_size=16, combine="pallas",
              member_dtypes=["fp32", "int8"])
    ops.reset_counts()
    with make_system(tcfgs, tparams, [[8, 16]], **kw) as s:
        Y = s.predict(X)
    assert ops.plain_calls()["ensemble_accumulate_quant"] > 0
    devs = jhost_cpus(1, memory_bytes=8 * 1024 ** 3)
    alloc = JAllocationMatrix(devs, [c.name for c in jcfgs],
                              np.array([[8, 16]]))
    with JInferenceSystem(jcfgs, jparams, alloc, max_seq=SEQ, **kw) as js:
        Yj = js.predict(X)
    # the int8 member's per-row logit scale, from its dequantized forward
    from repro.kernels import quant as jq
    lg, _ = M.forward(jq.dequantize_params(jq.quantize_params(jparams[1],
                                                              "int8")),
                      jcfgs[1], jnp.asarray(X))
    _, scale = jq.quantize_symmetric(lg[:, -1, :jcfgs[1].vocab_size], axis=-1)
    # each element is within 2e-5 of a whole number of steps, k in {-1,0,1}
    step = 0.5 * np.asarray(scale)
    k = np.rint((Y - Yj) / step)
    assert (np.abs(k) <= 1).all()
    assert (np.abs(Y - Yj - k * step) <= 2e-5).all()
    assert (k != 0).mean() <= 0.01


@pytest.fixture(scope="module")
def ens_ssm():
    """ENS12 members 5 and 6: hymba (attention + SSM in every layer) and
    mamba2 (SSM only, no MLP); they share 512 classes."""
    jcfgs = jensemble("ENS12")[5:7]
    rng = jax.random.PRNGKey(1)
    jparams = [M.init_params(jax.random.fold_in(rng, i), c)
               for i, c in enumerate(jcfgs)]
    tparams = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
               for p in jparams]
    return jcfgs, ensemble("ENS12")[5:7], jparams, tparams


@pytest.mark.parametrize("combine", ["mean", "pallas"])
def test_ssm_and_hybrid_members_match_jax_oracle(ens_ssm, combine):
    jcfgs, tcfgs, jparams, tparams = ens_ssm
    X = _X(40, seed=8)
    ops.reset_counts()
    with make_system(tcfgs, tparams, [[16, 8]], combine=combine,
                     use_kernel=True, segment_size=16) as s:
        Y = s.predict(X)
    np.testing.assert_allclose(Y, oracle(jcfgs, jparams, X), atol=2e-5)
    calls = ops.plain_calls()
    # every chunk of each member runs the scan once per layer; only hymba
    # runs attention
    assert calls["ssd_scan"] >= sum(c.num_layers for c in tcfgs) * 3
    assert calls["flash_attention"] >= tcfgs[0].num_layers * 3
    assert (calls["ensemble_accumulate"] > 0) == (combine == "pallas")


def test_int8_ssm_member_matches_jax_system(ens_ssm):
    """hymba fp32 + mamba2 int8 (A_log, dt_bias, D and norm quantized per
    repeat, as in the reference) under 'pallas' against the JAX system with
    the same settings, to whole int8 steps as in
    test_int8_member_matches_jax_system."""
    jcfgs, tcfgs, jparams, tparams = ens_ssm
    X = _X(40, seed=9)
    kw = dict(segment_size=16, combine="pallas",
              member_dtypes=["fp32", "int8"])
    ops.reset_counts()
    with make_system(tcfgs, tparams, [[8, 16]], use_kernel=True, **kw) as s:
        Y = s.predict(X)
    assert ops.plain_calls()["ensemble_accumulate_quant"] > 0
    assert ops.plain_calls()["ssd_scan"] > 0
    devs = jhost_cpus(1, memory_bytes=8 * 1024 ** 3)
    alloc = JAllocationMatrix(devs, [c.name for c in jcfgs],
                              np.array([[8, 16]]))
    with JInferenceSystem(jcfgs, jparams, alloc, max_seq=SEQ, **kw) as js:
        Yj = js.predict(X)
    from repro.kernels import quant as jq
    lg, _ = M.forward(jq.dequantize_params(jq.quantize_params(jparams[1],
                                                              "int8")),
                      jcfgs[1], jnp.asarray(X))
    _, scale = jq.quantize_symmetric(lg[:, -1, :jcfgs[1].vocab_size], axis=-1)
    step = 0.5 * np.asarray(scale)
    k = np.rint((Y - Yj) / step)
    assert (np.abs(k) <= 1).all()
    assert (np.abs(Y - Yj - k * step) <= 2e-5).all()
    assert (k != 0).mean() <= 0.01


def test_concurrent_requests_coalesce(ens2):
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _X(80, seed=6)
    with make_system(tcfgs, tparams, [[16, 8]], combine="pallas",
                     use_kernel=True, segment_size=32) as s:
        handles = [s.predict_async(X[i * 20:(i + 1) * 20]) for i in range(4)]
        Y = np.concatenate([h.result(120.0) for h in handles])
        assert s.serving_counters()["rows_valid"] == 80 * 2
        assert all(h.latency_s > 0 for h in handles)
    np.testing.assert_allclose(Y, oracle(jcfgs, jparams, X), atol=2e-5)


def test_simulated_cell_serves_only_fake_workers(ens2):
    """A cell without a torch_device never hosts a real member: the CPU must
    be asked for through host_cpus(), the card through cuda_devices()."""
    _, tcfgs, _, tparams = ens2
    cell = dataclasses.replace(host_cpus(1)[0], torch_device=None)
    alloc = AllocationMatrix([cell], [c.name for c in tcfgs],
                             np.array([[8, 8]]))
    with pytest.raises(ValueError, match="torch_device"):
        InferenceSystem(tcfgs, tparams, alloc, max_seq=SEQ)
    with InferenceSystem(tcfgs, tparams, alloc, max_seq=SEQ, fake=True) as s:
        assert s.predict(_X(8, seed=7)).shape == (8, tcfgs[0].vocab_size)


def test_unported_options_raise(ens2):
    _, tcfgs, _, tparams = ens2
    for kw in (dict(supervise=True), dict(fault_plan=object()),
               dict(admission_budget=1 << 20)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_system(tcfgs, tparams, [[8, 8]], **kw)
    with make_system(tcfgs, tparams, [[8, 8]], fake=True) as s:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            s.spawn_instance(0, 0, 8)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            s.drain_instance(s.workers[0])


@pytest.fixture(scope="module")
def ens4():
    """All of ENS4: qwen3, llama3, gemma3 (sliding window) and granite
    (MoE), as the JAX package and the port."""
    jcfgs = jensemble("ENS4")
    rng = jax.random.PRNGKey(4)
    jparams = [M.init_params(jax.random.fold_in(rng, i), c)
               for i, c in enumerate(jcfgs)]
    tparams = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
               for p in jparams]
    return jcfgs, ensemble("ENS4"), jparams, tparams


def _jax_system(jcfgs, jparams, A, **kw):
    A = np.array(A)
    devs = jhost_cpus(A.shape[0], memory_bytes=8 * 1024 ** 3)
    alloc = JAllocationMatrix(devs, [c.name for c in jcfgs], A)
    return JInferenceSystem(jcfgs, jparams, alloc, max_seq=SEQ, **kw)


@pytest.mark.parametrize("combine", ["mean", "pallas"])
def test_all_of_ens4_matches_jax_system(ens4, combine):
    """The paper's four-member ensemble, the MoE member included, on two
    cells (co-located and data-parallel) against the JAX system."""
    jcfgs, tcfgs, jparams, tparams = ens4
    X = _X(50, seed=11)
    A = [[8, 16, 0, 8], [0, 8, 16, 8]]
    with make_system(tcfgs, tparams, A, segment_size=16,
                     combine=combine) as s:
        Y = s.predict(X)
    with _jax_system(jcfgs, jparams, A, segment_size=16,
                     combine=combine) as js:
        Yj = js.predict(X)
    np.testing.assert_allclose(Y, Yj, atol=2e-5)


def test_cross_attention_member_serves_its_frontend(ens2):
    """llama-3.2-vision (ENS12's cross-attention member) beside qwen3, with
    a nonzero frontend (one seeded row repeated, so a row's answer does not
    depend on where the batcher puts it) against the JAX system given the
    same frontend; the frontend moves Y, so it was read."""
    jcfgs = [jensemble("ENS12")[9], jensemble("ENS4")[0]]
    tcfgs = [ensemble("ENS12")[9], ensemble("ENS4")[0]]
    jparams = [M.init_params(jax.random.PRNGKey(9), jcfgs[0]),
               ens2[2][0]]
    tparams = [params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        jparams[0]), "cpu"),
               ens2[3][0]]
    cfg = tcfgs[0]
    row = np.random.default_rng(12).standard_normal(
        (1, cfg.frontend_tokens, cfg.fdim)).astype(np.float32)
    fe = np.repeat(row, 16, axis=0)
    X = _X(40, seed=12)
    kw = dict(segment_size=16, combine="pallas")
    with make_system(tcfgs, tparams, [[16, 8]], frontends={0: fe},
                     **kw) as s:
        Y = s.predict(X)
        assert s.workers[0].frontend.shape == fe.shape
    with _jax_system(jcfgs, jparams, [[16, 8]], frontends={0: fe}, **kw) as js:
        Yj = js.predict(X)
    np.testing.assert_allclose(Y, Yj, atol=2e-5)
    with make_system(tcfgs, tparams, [[16, 8]], **kw) as s:
        assert not s.workers[0].frontend.any()        # the zero default
        Y0 = s.predict(X)
    assert np.abs(Y - Y0).max() > 1e-4
