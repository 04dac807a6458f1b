"""The port's allocator (``repro_torch.core``) against the JAX package's:
the memory model, Algorithm 1 (worst-fit-decreasing), Algorithm 2 (bounded
greedy), the optimizer and its cache, and the BBS baseline return identical
matrices and scores for the same inputs and seed.  The cases of
tests/test_allocation.py and tests/test_allocation_property.py are held on
the port (hypothesis example counts no larger than theirs), and one small
``MeasuredBench`` run serves the torch system in Benchmark Mode on the CPU.

The port keeps the V100 figures out of its devices; simulated GPUs here
are given the JAX package's V100 figures explicitly, so both packages
score the same cells."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402

import repro.core as J  # noqa: E402
import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import bbs as jbbs  # noqa: E402
from repro.core import devices as jdev  # noqa: E402
from repro.core import memory as jmem  # noqa: E402
from repro_torch.configs import ensemble, get_config  # noqa: E402
from repro_torch.core import (AllocationMatrix, AllocationOptimizer,  # noqa: E402
                              AnalyticBench, MeasuredBench, MemoBench,
                              best_batch_strategy, bounded_greedy, host_cpus,
                              simulated_gpus, worst_fit_decreasing, zeros)
from repro_torch.core import devices as tdev  # noqa: E402
from repro_torch.core import memory as mem  # noqa: E402
from repro_torch.core.allocation import DEFAULT_BATCH_SIZES  # noqa: E402
from repro_torch.core.bbs import BBSError, analytic_single_bench  # noqa: E402
from repro_torch.core.worst_fit import AllocationError  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

GiB = 1024 ** 3
MiB = 1024 ** 2


def gpus(n, memory_bytes=jdev.V100_HBM_BYTES):
    """The port's simulated GPUs at the JAX package's V100 figures."""
    return simulated_gpus(n, memory_bytes, jdev.V100_PEAK_FLOPS,
                          jdev.V100_HBM_BW)


# (gpus, gpu GiB, cpus, cpu GiB) of paired device lists
SETUPS = [(4, 2, 1, 8), (2, 4, 0, 0), (1, 70 / 1024, 1, 16), (3, 1, 1, 4),
          (16, 2, 0, 0)]


def _devices(n_gpu, gpu_gib, n_cpu, cpu_gib):
    """The same cells in the JAX package and in the port."""
    gb, cb = int(gpu_gib * GiB), int(cpu_gib * GiB)
    jd = jdev.simulated_gpus(n_gpu, gb) + \
        (J.host_cpus(n_cpu, cb) if n_cpu else [])
    td = gpus(n_gpu, gb) + (host_cpus(n_cpu, cb) if n_cpu else [])
    return jd, td


@pytest.fixture
def ens4():
    return ensemble("ENS4")


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
def test_worker_bytes_match_jax():
    names = [c.name for c in jensemble("ENS12")]
    pairs = list(zip(jensemble("ENS12") + jensemble("ENS4"),
                     ensemble("ENS12") + ensemble("ENS4")))
    pairs += [(jget_config(n), get_config(n))
              for n in ("granite-moe-3b-a800m", "llama-3.2-vision-11b")]
    assert names
    for jc, tc in pairs:
        for batch in (1, 8, 64):
            for dt in (None, "fp32", "bf16", "int8", "fp8"):
                for cache in (0, 512):
                    assert mem.worker_bytes(
                        tc, batch, 128, serving_cache_len=cache,
                        member_dtype=dt) == jmem.worker_bytes(
                        jc, batch, 128, serving_cache_len=cache,
                        member_dtype=dt), (tc.name, batch, dt, cache)


def test_quantized_param_bytes_match_jax():
    from repro.kernels import quant as jquant
    jc = jensemble("ENS4")[3]                       # granite (MoE)
    jp = M.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for dt in ("int8", "bf16", "fp32"):
        assert tquant.quantized_param_bytes(tp, dt) == \
            jquant.quantized_param_bytes(jp, dt)


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("ens", ["ENS4", "ENS12"])
def test_worst_fit_matches_jax(setup, ens):
    jd, td = _devices(*setup)
    try:
        want = J.worst_fit_decreasing(jensemble(ens), jd)
    except J.AllocationError:
        with pytest.raises(AllocationError):
            worst_fit_decreasing(ensemble(ens), td)
        return
    got = worst_fit_decreasing(ensemble(ens), td)
    np.testing.assert_array_equal(got.A, want.A)
    assert got.key() == want.key()


def test_worst_fit_with_member_dtypes_matches_jax():
    jd, td = _devices(2, 1, 1, 4)
    dts = ["int8", None, "bf16", "fp8"]
    want = J.worst_fit_decreasing(jensemble("ENS4"), jd, member_dtypes=dts)
    got = worst_fit_decreasing(ensemble("ENS4"), td, member_dtypes=dts)
    np.testing.assert_array_equal(got.A, want.A)


@pytest.mark.parametrize("ens,setup,seed", [
    ("ENS4", (4, 2, 1, 8), 0), ("ENS4", (4, 2, 1, 8), 3),
    ("ENS4", (2, 4, 0, 0), 1), ("ENS12", (3, 1, 1, 4), 0),
    ("ENS1", (16, 2, 0, 0), 2)])
def test_bounded_greedy_matches_jax(ens, setup, seed):
    """Same start, same seed: the same neighbours are drawn and scored, so
    the matrix, the scores and the counts agree exactly."""
    jd, td = _devices(*setup)
    jstart = J.worst_fit_decreasing(jensemble(ens), jd)
    tstart = worst_fit_decreasing(ensemble(ens), td)
    want, wtrace = J.bounded_greedy(jstart, J.AnalyticBench(jensemble(ens)),
                                    max_iter=6, max_neighs=30, seed=seed)
    got, gtrace = bounded_greedy(tstart, AnalyticBench(ensemble(ens)),
                                 max_iter=6, max_neighs=30, seed=seed)
    np.testing.assert_array_equal(got.A, want.A)
    assert gtrace.scores == wtrace.scores
    assert (gtrace.evaluated, gtrace.iterations) == \
        (wtrace.evaluated, wtrace.iterations)
    assert gtrace.visited_rate == wtrace.visited_rate


def test_optimizer_matches_jax_and_shares_its_cache(tmp_path):
    """The whole procedure gives JAX's matrices and scores, and the port
    reads the matrix JAX cached (the same key and file format)."""
    jd, td = _devices(4, 2, 1, 8)
    cache = str(tmp_path / "alloc_cache.json")
    want = J.AllocationOptimizer(jensemble("ENS4"), jd,
                                 J.AnalyticBench(jensemble("ENS4")),
                                 max_iter=4, max_neighs=40, seed=5,
                                 cache_path=cache).optimize()
    got = AllocationOptimizer(ensemble("ENS4"), td,
                              AnalyticBench(ensemble("ENS4")),
                              max_iter=4, max_neighs=40, seed=5).optimize()
    np.testing.assert_array_equal(got.matrix.A, want.matrix.A)
    np.testing.assert_array_equal(got.wfd_matrix.A, want.wfd_matrix.A)
    assert (got.wfd_score, got.final_score) == (want.wfd_score,
                                                want.final_score)
    again = AllocationOptimizer(ensemble("ENS4"), td,
                                AnalyticBench(ensemble("ENS4")),
                                max_iter=4, max_neighs=40, seed=5,
                                cache_path=cache).optimize()
    assert again.from_cache
    np.testing.assert_array_equal(again.matrix.A, want.matrix.A)


def test_bbs_matches_jax():
    jd, td = _devices(4, 2, 1, 8)
    want, wn = J.best_batch_strategy(jensemble("ENS4"), jd,
                                     jbbs.analytic_single_bench(seq=128))
    got, gn = best_batch_strategy(ensemble("ENS4"), td,
                                  analytic_single_bench(seq=128))
    np.testing.assert_array_equal(got.A, want.A)
    assert gn == wn


def test_devices_keep_no_tpu_or_v100_figures():
    """Simulated GPUs default to the H100 row; the card's own cells read
    their memory from the card and refuse to exist without one."""
    g = simulated_gpus(2, 80 * GiB)
    assert (g[0].peak_flops, g[0].mem_bw) == (67e12, 3.35e12)
    assert g[0].torch_device is None and g[0].is_accelerator
    assert not [k for k in vars(tdev) if "V100" in k or "TPU" in k]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tdev.cuda_devices()


def test_cuda_devices_take_rates_only_for_the_card_they_were_measured_on(
        monkeypatch):
    """A card's cell gets the H100 row's rates only under that card's full
    name; an H100 of another form (PCIe, NVL) has other rates and gets 0."""
    names = ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"]

    class Props:
        def __init__(self, name):
            self.name, self.total_memory = name, 80 * GiB
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(names))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props(names[i]))
    cells = tdev.cuda_devices()
    assert [(c.peak_flops, c.mem_bw) for c in cells] == [
        (67e12, 3.35e12), (0.0, 0.0), (0.0, 0.0)]
    assert [c.memory_bytes for c in cells] == [80 * GiB] * 3


# ---------------------------------------------------------------------------
# tests/test_allocation.py, on the port
# ---------------------------------------------------------------------------
def test_matrix_validity(ens4):
    devs = gpus(3)
    names = [c.name for c in ens4]
    a = zeros(devs, names)
    assert not a.is_valid()                  # all-zero columns illegal
    a.A[:, :] = 8
    assert a.is_valid()
    a.A[:, 2] = 0
    assert not a.is_valid()
    a.A[0, 2] = 16
    assert a.is_valid()
    a.A[1, :] = 0                            # idle device row is legal
    assert a.is_valid()


def test_eq1_decision_space():
    total = AllocationMatrix.total_matrices(D=5, M=8, B=5)
    assert 1.2e31 < total < 1.4e31


def test_eq2_neighborhood():
    devs = gpus(4) + host_cpus(1)
    a = zeros(devs, [f"m{i}" for i in range(8)])
    a.A[0, :] = 8
    assert 232 <= a.total_neighbors() <= 240
    for cand in a.neighbors(DEFAULT_BATCH_SIZES):
        assert cand.is_valid()
        assert (cand.A != a.A).sum() == 1


def test_worst_fit_places_all(ens4):
    devs = gpus(4, memory_bytes=2 * GiB) + host_cpus(1, 8 * GiB)
    alloc = worst_fit_decreasing(ens4, devs)
    alloc.validate()
    assert alloc.num_workers() == 4
    assert mem.fit_mem(alloc, ens4, 128)
    assert alloc.A[-1].sum() == 0            # GPU priority


def test_worst_fit_colocates_when_fewer_devices(ens4):
    alloc = worst_fit_decreasing(ens4, gpus(2, memory_bytes=4 * GiB))
    alloc.validate()
    assert max(len(alloc.colocated(d)) for d in range(2)) >= 2


def test_worst_fit_oom(ens4):
    with pytest.raises(AllocationError):
        worst_fit_decreasing(ens4, gpus(1, memory_bytes=20 * MiB))


def test_worst_fit_spills_to_cpu(ens4):
    devs = gpus(1, memory_bytes=70 * MiB) + host_cpus(1, 16 * GiB)
    alloc = worst_fit_decreasing(ens4, devs)
    assert alloc.A[1].sum() > 0


def test_greedy_improves_and_is_monotone(ens4):
    devs = gpus(4, memory_bytes=2 * GiB) + host_cpus(1, 8 * GiB)
    bench = MemoBench(AnalyticBench(ens4, seq=128))
    start = worst_fit_decreasing(ens4, devs)
    best, trace = bounded_greedy(start, bench, max_iter=10, max_neighs=60)
    assert trace.scores == sorted(trace.scores)
    assert bench(best) >= bench(start)
    assert best.is_valid()


def test_greedy_max_iter_extension():
    """paper §III: when D - M > max_iter, max_iter grows to D - M."""
    cfgs = ensemble("ENS1")
    devs = gpus(16, memory_bytes=2 * GiB)
    start = worst_fit_decreasing(cfgs, devs)
    best, trace = bounded_greedy(start, AnalyticBench(cfgs, seq=128),
                                 max_iter=3, max_neighs=200)
    assert trace.iterations > 3
    assert best.instances(0)


def test_optimizer_cache_roundtrip(tmp_path, ens4):
    devs = gpus(4, memory_bytes=2 * GiB)
    bench = AnalyticBench(ens4, seq=128)
    cache = str(tmp_path / "alloc_cache.json")
    r1 = AllocationOptimizer(ens4, devs, bench, max_iter=2, max_neighs=20,
                             cache_path=cache).optimize()
    assert not r1.from_cache
    r2 = AllocationOptimizer(ens4, devs, bench, max_iter=2, max_neighs=20,
                             cache_path=cache).optimize()
    assert r2.from_cache
    assert np.array_equal(r1.matrix.A, r2.matrix.A)


def test_bbs_requires_enough_devices(ens4):
    with pytest.raises(BBSError):
        best_batch_strategy(ens4, gpus(2), analytic_single_bench())


def test_bbs_vs_optimizer(ens4):
    """The optimizer must beat or match BBS (paper Table III)."""
    devs = gpus(4, memory_bytes=2 * GiB) + host_cpus(1, 8 * GiB)
    bench = MemoBench(AnalyticBench(ens4, seq=128))
    bbs_alloc, nbench = best_batch_strategy(ens4, devs,
                                            analytic_single_bench(seq=128))
    assert nbench == len(ens4) * len(DEFAULT_BATCH_SIZES)
    res = AllocationOptimizer(ens4, devs, bench, max_iter=10,
                              max_neighs=100).optimize()
    assert res.final_score >= bench(bbs_alloc)


def test_memory_model_monotone(ens4):
    c = ens4[0]
    b8 = mem.worker_bytes(c, 8, 128)
    b128 = mem.worker_bytes(c, 128, 128)
    assert b128 > b8 > c.param_count() * 4


# ---------------------------------------------------------------------------
# tests/test_allocation_property.py, on the port
# ---------------------------------------------------------------------------
ENS = ensemble("ENS4")
BATCHES = (0,) + DEFAULT_BATCH_SIZES


@st.composite
def matrices(draw, max_d=5, models=4):
    d = draw(st.integers(1, max_d))
    a = np.array([[draw(st.sampled_from(BATCHES)) for _ in range(models)]
                  for _ in range(d)])
    return AllocationMatrix(gpus(d), [c.name for c in ENS[:models]], a)


@given(matrices())
@settings(max_examples=60, deadline=None)
def test_neighbors_preserve_validity(alloc):
    if not alloc.is_valid():
        return
    for n in alloc.neighbors(DEFAULT_BATCH_SIZES):
        assert n.is_valid()
        assert (n.A != alloc.A).sum() == 1


@given(matrices())
@settings(max_examples=60, deadline=None)
def test_key_is_canonical(alloc):
    same = AllocationMatrix(alloc.devices, alloc.model_names, alloc.A.copy())
    assert alloc.key() == same.key()
    edited = alloc.copy()
    edited.A[0, 0] = 8 if edited.A[0, 0] != 8 else 16
    assert edited.key() != alloc.key()


@given(matrices())
@settings(max_examples=40, deadline=None)
def test_bench_zero_iff_invalid_or_oom(alloc):
    """0 exactly for invalid or infeasible matrices, and the JAX package's
    score on the same matrix."""
    bench = AnalyticBench(ENS, seq=128)
    score = bench(alloc)
    feasible = alloc.is_valid() and mem.fit_mem(alloc, ENS, 128,
                                                bench.dtype_bytes)
    assert (score > 0) == feasible
    jalloc = J.AllocationMatrix(jdev.simulated_gpus(len(alloc.devices)),
                                alloc.model_names, alloc.A.copy())
    assert score == J.AnalyticBench(jensemble("ENS4"), seq=128)(jalloc)


@given(st.integers(1, 8), st.integers(1, 60))
@settings(max_examples=30, deadline=None)
def test_worst_fit_feasible_or_error(n_gpus, mem_hundred_mib):
    devs = gpus(n_gpus, memory_bytes=mem_hundred_mib * 100 * MiB)
    try:
        alloc = worst_fit_decreasing(ENS, devs)
    except AllocationError:
        return
    assert alloc.is_valid()
    assert mem.fit_mem(alloc, ENS, 128)
    assert alloc.num_workers() == len(ENS)


@given(st.integers(2, 10), st.integers(2, 12), st.integers(1, 6))
@settings(max_examples=30, deadline=None)
def test_eq1_grows_with_dims(d, m, b):
    t = AllocationMatrix.total_matrices(d, m, b)
    assert t > AllocationMatrix.total_matrices(d - 1, m, b)
    assert t > AllocationMatrix.total_matrices(d, m - 1, b)


@given(matrices())
@settings(max_examples=40, deadline=None)
def test_device_usage_additive(alloc):
    usage = mem.device_usage(alloc, ENS, 128)
    expect = [0] * len(alloc.devices)
    for d, m, b in alloc.workers():
        expect[d] += mem.worker_bytes(ENS[m], b, 128)
    assert usage == expect


# ---------------------------------------------------------------------------
# Benchmark Mode
# ---------------------------------------------------------------------------
def test_measured_bench_serves_the_torch_system():
    """The paper's bench on the CPU: each matrix builds the torch system in
    Benchmark Mode and times the calibration rows; an invalid or
    infeasible matrix scores 0 without building anything, and the memo
    scores a revisit once."""
    jcfgs = jensemble("ENS4")[:2]
    cfgs = ensemble("ENS4")[:2]
    params = [params_from_numpy(jax.tree_util.tree_map(
        np.asarray, M.init_params(jax.random.PRNGKey(i), c)), "cpu")
        for i, c in enumerate(jcfgs)]
    X = np.random.default_rng(0).integers(0, 512, (32, 16)).astype(np.int32)
    inner = MeasuredBench(cfgs, params, X, segment_size=16)
    bench = MemoBench(inner)
    names = [c.name for c in cfgs]
    ok = AllocationMatrix(host_cpus(1, 8 * GiB), names, np.array([[8, 16]]))
    assert bench(ok) > 0
    assert bench(ok) > 0 and bench.hits == 1 and inner.calls == 1
    assert bench(AllocationMatrix(host_cpus(1, 8 * GiB), names,
                                  np.array([[8, 0]]))) == 0.0
    assert bench(AllocationMatrix(host_cpus(1, MiB), names,
                                  np.array([[8, 8]]))) == 0.0
