"""Quantization helpers of the PyTorch port against the JAX package's
``repro.kernels.quant``: the same inputs (numpy, from a seed) through both.
Codes may differ by at most one quantization step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble  # noqa: E402
from repro.kernels import quant as jq  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402


def _code_step(codes: np.ndarray, dtype: str) -> np.ndarray:
    """One quantization step at each code's magnitude: 1 for int8, the
    e4m3 spacing (3 mantissa bits, subnormal step 2^-9) for fp8."""
    if dtype == "int8":
        return np.ones_like(codes)
    mag = np.maximum(np.abs(codes), 2.0 ** -6)
    return 2.0 ** (np.floor(np.log2(mag)) - 3)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_symmetric_matches_jax(dtype, axis):
    x = np.random.default_rng(0).standard_normal((24, 40)).astype(np.float32)
    x[3] = 0.0                                     # an all-zero channel
    jcode, jscale = jq.quantize_symmetric(jnp.asarray(x), axis=axis,
                                          dtype=dtype)
    tcode, tscale = tq.quantize_symmetric(torch.from_numpy(x), axis=axis,
                                          dtype=dtype)
    assert tuple(tscale.shape) == jscale.shape
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-6)
    a = tcode.float().numpy()
    b = np.asarray(jcode.astype(jnp.float32))
    assert (np.abs(a - b) <= _code_step(np.maximum(np.abs(a), np.abs(b)),
                                        dtype)).all()
    np.testing.assert_allclose(
        tq.dequantize(tcode, tscale).numpy(),
        np.asarray(jq.dequantize(jcode, jscale)),
        atol=float(np.asarray(jscale).max()) * (1.0 if dtype == "int8" else 32.0))


def test_member_dtype_helpers_match_jax():
    for name in ("fp32", "bf16", "int8", "fp8", None):
        assert tq.dtype_bytes(name) == jq.dtype_bytes(name)
        assert tq.is_quantized_dtype(name) == jq.is_quantized_dtype(name)
    for have in ("fp32", "bf16", "int8", "fp8", None):
        for floor in ("fp32", "bf16", "int8", "fp8", None):
            assert tq.meets_precision(have, floor) == \
                jq.meets_precision(have, floor)
    with pytest.raises(ValueError):
        tq.validate_member_dtype("int4")


@pytest.mark.parametrize("dtype", ["int8", "fp8", "bf16", "fp32"])
def test_quantize_params_matches_jax(dtype):
    cfg = ensemble("ENS4")[0]
    jparams = M.init_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    jwrapped = jq.quantize_params(jparams, dtype)
    twrapped = tq.quantize_params(tparams, dtype)
    jleaves = jax.tree_util.tree_leaves(jwrapped)
    tleaves = []
    tq.tree_map(tleaves.append, twrapped)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):         # same wrapping, same order
        assert tuple(t.shape) == j.shape
    jback = jax.tree_util.tree_leaves(jq.dequantize_params(jwrapped))
    tback = []
    tq.tree_map(tback.append, tq.dequantize_params(twrapped))
    for j, t in zip(jback, tback):
        j = np.asarray(j)
        assert t.dtype == torch.float32
        # one code step of the largest per-channel scale at most
        tol = 0.0 if dtype == "fp32" else float(np.abs(j).max()) / 100.0
        np.testing.assert_allclose(t.numpy(), j, atol=tol)


def test_leaf_dequantizes_one_repeat():
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((3, 8, 16)).astype(np.float32))
    wrapped = tq.quantize_params({"w": x}, "int8")["w"]
    whole = tq.dequantize(wrapped["q"], wrapped["s"])
    for r in range(3):
        assert torch.equal(tq.leaf(wrapped, r), whole[r])
    assert torch.equal(tq.leaf(x, 1), x[1])
