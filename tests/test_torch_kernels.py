"""Kernel entries of the PyTorch port against the JAX package's.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode through ``repro.kernels.ops``.  Inputs
are made with numpy from a seed and fed to both.  Tolerances are the JAX
suite's (tests/test_kernels.py, tests/test_quantized.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402

FLASH_CASES = [
    # (b, s, h, kv, hd, window, dtype) — tests/test_kernels.py:15-23
    (2, 64, 4, 2, 32, 0, "float32"),
    (1, 128, 4, 4, 64, 0, "float32"),
    (2, 96, 8, 2, 80, 32, "float32"),
    (1, 256, 4, 1, 128, 64, "float32"),
    (1, 200, 2, 2, 48, 0, "float32"),
    (2, 64, 4, 2, 64, 0, "bfloat16"),
]
COMBINE_CASES = [(4, 128, 100), (12, 44, 91), (3, 128, 1000), (1, 7, 13)]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x, dtype="float32"):
    """The same numpy array as a jax array and a torch tensor of ``dtype``
    (both round f32 -> bf16 to nearest even)."""
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("b,s,h,kv,hd,window,dtype", FLASH_CASES)
def test_flash_attention_matches_jax(b, s, h, kv, hd, window, dtype):
    jq, tq = _both(_np(1, b, s, h, hd), dtype)
    jk, tk = _both(_np(2, b, s, kv, hd), dtype)
    jv, tv = _both(_np(3, b, s, kv, hd), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_attention_on_cpu_runs_the_plain_version():
    q = torch.from_numpy(_np(4, 1, 16, 2, 32))
    k = torch.from_numpy(_np(5, 1, 16, 1, 32))
    ops.reset_counts()
    ops.flash_attention(q, k, k)
    assert ops.plain_calls()["flash_attention"] == 1
    assert ops.kernel_launches()["flash_attention"] == 0


@pytest.mark.parametrize("m,seg,c", COMBINE_CASES)
def test_ensemble_combine_matches_jax(m, seg, c):
    jp, tp = _both(_np(12, m, seg, c))
    w = np.random.default_rng(13).dirichlet(np.ones(m)).astype(np.float32)
    jw, tw = _both(w)
    want = jops.ensemble_combine(jp, jw)
    np.testing.assert_allclose(ops.ensemble_combine(tp, tw).numpy(),
                               np.asarray(want), atol=1e-5)


def test_ensemble_combine_is_paper_rule():
    """Uniform weights reproduce Y += P/M."""
    m, seg, c = 5, 16, 10
    p = _np(14, m, seg, c)
    out = ops.ensemble_combine(torch.from_numpy(p), torch.full((m,), 1.0 / m))
    acc = np.zeros((seg, c), np.float32)
    for i in range(m):
        acc += p[i] / m
    np.testing.assert_allclose(out.numpy(), acc, atol=1e-6)


@pytest.mark.parametrize("m,seg,c", COMBINE_CASES)
def test_ensemble_accumulate_matches_jax(m, seg, c):
    jp, tp = _both(_np(15, m, seg, c))
    w = np.random.default_rng(16).dirichlet(np.ones(m)).astype(np.float32)
    jw, tw = _both(w)
    jpart, tpart = _both(_np(17, seg, c))
    want = np.asarray(jops.ensemble_accumulate(jpart, jp, jw))
    np.testing.assert_allclose(ops.ensemble_accumulate(tpart, tp, tw).numpy(),
                               want, atol=1e-5)
    # in place, as the device combiner folds into its partial
    ops.ensemble_accumulate(tpart, tp, tw, out=tpart)
    np.testing.assert_allclose(tpart.numpy(), want, atol=1e-5)


def test_ensemble_accumulate_chains():
    """Folding members one at a time equals one fused combine (JAX's)."""
    m, seg, c = 4, 20, 100
    p = _np(18, m, seg, c)
    w = np.random.default_rng(19).dirichlet(np.ones(m)).astype(np.float32)
    acc = torch.zeros((seg, c))
    for i in range(m):
        ops.ensemble_accumulate(acc, torch.from_numpy(p[i][None]),
                                torch.from_numpy(w[i:i + 1]), out=acc)
    want = jops.ensemble_combine(jnp.asarray(p), jnp.asarray(w))
    np.testing.assert_allclose(acc.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype,m,seg,c", [
    ("int8", 1, 8, 512), ("int8", 3, 40, 512), ("int8", 2, 128, 640),
    ("fp8", 2, 16, 512)])
def test_ensemble_accumulate_quant_matches_jax(dtype, m, seg, c):
    rng = np.random.default_rng(seg)
    logits = rng.normal(size=(m, seg, c)).astype(np.float32) * 4.0
    partial = rng.normal(size=(seg, c)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, m).astype(np.float32)
    jqs = [jquant.quantize_symmetric(jnp.asarray(x), axis=-1, dtype=dtype)
           for x in logits]
    want = jops.ensemble_accumulate_quant(
        jnp.asarray(partial), jnp.stack([a for a, _ in jqs]),
        jnp.stack([b[:, 0] for _, b in jqs]), jnp.asarray(w))
    tqs = [tquant.quantize_symmetric(torch.from_numpy(x), axis=-1,
                                     dtype=dtype) for x in logits]
    got = ops.ensemble_accumulate_quant(
        torch.from_numpy(partial), torch.stack([a for a, _ in tqs]),
        torch.stack([b[:, 0] for _, b in tqs]), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 32)),
                            torch.zeros((1, 8, 3, 32)))   # 4 heads, 3 kv
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros((1, 8, 4, 288)),
                            torch.zeros((1, 8, 4, 288)),
                            torch.zeros((1, 8, 4, 288)))  # hd > 256
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        ops.ensemble_combine(torch.zeros((2, 4, 8)), torch.zeros(3))
    with pytest.raises(ValueError):
        ops.ensemble_accumulate_quant(torch.zeros((4, 8)),
                                      torch.zeros((1, 4, 8), dtype=torch.int8),
                                      torch.zeros((1, 5)), torch.ones(1))
    with pytest.raises(TypeError):
        ops.ensemble_accumulate_quant(torch.zeros((4, 8)),
                                      torch.zeros((1, 4, 8)),
                                      torch.zeros((1, 4)), torch.ones(1))


def test_reset_counts_zeroes_every_counter():
    ref.ensemble_combine_ref(torch.zeros((1, 2, 3)), torch.ones(1))
    ops.reset_counts()
    assert not any(ops.plain_calls().values())
    assert not any(ops.kernel_launches().values())


def test_pow2_clamp_matches_jax():
    for n in (1, 2, 3, 7, 8, 9, 100, 129):
        assert ops.pow2_clamp(n, 8, 64) == jops.pow2_clamp(n, 8, 64)
