"""The port's SSD scan, Mamba2 mixer and SSM / hybrid member forwards against
the JAX package on the same numpy inputs.

On the CPU the port's ``ssd_scan`` wrapper runs its plain version; the JAX
side runs its Pallas kernel in interpret mode through ``repro.kernels.ops``,
as its own suite does.  Tolerances are the JAX suite's
(tests/test_kernels.py for the scan, tests/test_torch_models.py for the
member forward)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SSD_CASES = [                    # (b, s, h, p, n, chunk) — test_kernels.py:59-64
    (2, 64, 4, 32, 16, 16),
    (1, 128, 8, 64, 32, 32),
    (2, 100, 4, 32, 16, 16),     # ragged s
    (1, 64, 2, 64, 128, 64),     # full mamba2-like state
]
MEMBERS = ["mamba2-1.3b-reduced", "hymba-1.5b-reduced"]
SSM_LEAVES = ("in_proj", "conv_w", "A_log", "dt_bias", "D", "norm", "out_proj")


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ssd_inputs(b, s, h, p, n):
    """The JAX suite's input distribution, drawn with numpy."""
    x = _np(7, b, s, h, p)
    dt = np.log1p(np.exp(_np(8, b, s, h)))                 # softplus
    A = -np.exp(_np(9, h) * 0.5)
    return x, dt, A, _np(10, b, s, n), _np(11, b, s, n)


def _tol(want):
    return 1e-4 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_scan_matches_jax(b, s, h, p, n, chunk):
    arrays = _ssd_inputs(b, s, h, p, n)
    want = np.asarray(jops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk))
    seq = np.asarray(jref.ssd_scan_sequential_ref(*map(jnp.asarray, arrays)))
    ops.reset_counts()
    got = ops.ssd_scan(*map(torch.from_numpy, arrays), chunk=chunk)
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    assert ops.plain_calls()["ssd_scan"] == 1
    assert ops.kernel_launches()["ssd_scan"] == 0
    for oracle in (want, seq):
        tol = _tol(oracle)
        np.testing.assert_allclose(got.numpy(), oracle, atol=tol, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES[1:3])
def test_ssd_sequential_ref_matches_jax(b, s, h, p, n, chunk):
    arrays = _ssd_inputs(b, s, h, p, n)
    want = np.asarray(jref.ssd_scan_sequential_ref(*map(jnp.asarray, arrays)))
    got = ref.ssd_scan_sequential_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), want, atol=_tol(want), rtol=1e-4)


def test_ssd_scan_wrapper_checks_its_inputs():
    x, dt, A, bm, cm = map(torch.from_numpy, _ssd_inputs(1, 16, 2, 8, 4))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt[:, :8], A, bm, cm, chunk=8)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, A, bm, cm, chunk=8)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, bm, cm, chunk=0)


# ---------------------------------------------------------------------------
# Mixer pieces
# (p, n, chunk) of every scan the card runs: chip_smoke.py's SSD_CASES, the
# card tests (tests/test_torch_cuda.py) and the reduced members
PLAN_CASES = [(32, 16, 16), (64, 32, 32), (64, 128, 64), (64, 16, 64),
              (32, 24, 32), (32, 16, 64), (96, 32, 32), (36, 8, 8),
              (64, 256, 64)]
SMEM_LIMIT = 227 * 1024          # bytes of shared memory a block may have


@pytest.mark.parametrize("p,n,chunk", PLAN_CASES)
def test_ssd_plan_fits_shared_memory(p, n, chunk):
    """The scan kernel's launch plan (the wrapper's mirror of the source's
    make_plan) fits 227 KB, and on the tensor cores its warp pairs cover
    the head dim."""
    pl = tssd.plan(p, n, chunk)
    assert pl["stages"] in (1, 2)
    assert pl["smem"] <= SMEM_LIMIT and pl["scores_smem"] <= SMEM_LIMIT
    assert pl["route"] == ("tensor_cores" if n >= 32 else "cuda_cores")
    if pl["route"] == "tensor_cores":
        w = pl["warps"]
        assert w % 2 == 0 and 2 <= w <= 8
        assert pl["groups"] * 8 * w >= p > (pl["groups"] - 1) * 8 * w
    if (p, n, chunk) == (64, 128, 64):            # mamba2, served
        assert pl["stages"] == 2 and pl["groups"] == 1


# (p, n, chunk, route): shapes whose layout at the caller's chunk does not
# fit 227 KB, or whose state is past the tensor-core route's 256
OVER_CASES = [
    (64, 128, 128, "tensor_cores"),   # 246 KB for one stage at chunk 128
    (64, 16, 256, "cuda_cores"),      # 372 KB at chunk 256
    (8, 256, 128, "tensor_cores"),
    (64, 512, 64, "cuda_cores"),      # N over 256
    (64, 512, 16, "cuda_cores"),
    (16, 1024, 64, "cuda_cores"),     # a large state at a narrow head
    (64, 760, 64, "cuda_cores"),      # the largest state at head dim 64
]


@pytest.mark.parametrize("p,n,chunk,route", OVER_CASES)
def test_ssd_plan_gives_every_shape_a_route_that_fits(p, n, chunk, route):
    """Where the caller's chunk does not fit, the kernel runs at the largest
    chunk that does (the result does not depend on it beyond rounding), and
    a state over 256 takes the CUDA-core route."""
    pl = tssd.plan(p, n, chunk)
    assert pl["route"] == route
    assert pl["stages"] in (1, 2)
    assert pl["smem"] <= SMEM_LIMIT and pl["scores_smem"] <= SMEM_LIMIT
    assert 0 < pl["chunk"] <= chunk and pl["chunk"] % 4 == 0
    if pl["route"] == "cuda_cores":
        assert pl["groups"] == 1 and n <= tssd.max_core_state(p)
    if pl["chunk"] < chunk:            # no larger chunk fits
        assert not tssd._fits(tssd._layout(p, n, pl["chunk"] + 4))


def test_ssd_plan_keeps_the_served_chunks_and_raises_only_past_any_layout():
    assert tssd.plan(64, 128, 64)["chunk"] == 64       # mamba2, served
    assert tssd.plan(64, 16, 64)["chunk"] == 64        # hymba, served
    assert tssd.plan(32, 16, 6)["chunk"] == 4          # rounded down to 4s
    assert tssd.max_core_state(64) == 760
    assert tssd._core_smem(64, 760, 4) <= SMEM_LIMIT
    assert tssd._core_smem(64, 764, 4) > SMEM_LIMIT
    with pytest.raises(ValueError, match="at most 760"):
        tssd.plan(64, 764, 64)


def test_causal_conv_matches_jax():
    xbc, w = _np(1, 2, 24, 40), _np(2, 4, 40) * 0.3
    want = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w))
    got = tssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_gated_norm_matches_jax():
    y, z, w = _np(3, 2, 12, 64), _np(4, 2, 12, 64), _np(5, 64) * 0.1
    want = jssm._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(w),
                            1e-6)
    got = tssm._gated_norm(torch.from_numpy(y), torch.from_numpy(z),
                           torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_softplus_matches_jax_beyond_torchs_threshold():
    """jax.nn.softplus is exact at every x; F.softplus returns x above 20."""
    x = np.concatenate([_np(6, 200) * 10.0,
                        np.array([-90.0, -30.0, 0.0, 19.9, 20.0, 20.1, 35.0,
                                  90.0], np.float32)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_segsum_exp_is_lower_triangular_and_finite():
    cs = torch.from_numpy(np.cumsum(-np.abs(_np(7, 3, 16)) * 8.0, -1))
    L = tssm.segsum_exp(cs)
    want = np.asarray(jssm.segsum_exp(jnp.asarray(cs.numpy())))
    assert torch.isfinite(L).all()
    assert (torch.triu(L, diagonal=1) == 0).all()
    np.testing.assert_allclose(L.numpy(), want, atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def members():
    """name -> (jax cfg, torch cfg, jax params, port params)."""
    out = {}
    for i, name in enumerate(MEMBERS):
        jcfg = jget_config(name)
        jp = M.init_params(jax.random.PRNGKey(20 + i), jcfg)
        tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
        out[name] = (jcfg, get_config(name), jp, tp)
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_mixer_matches_jax(members, use_kernel):
    jcfg, tcfg, jp, tp = members["mamba2-1.3b-reduced"]
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"][0])
    tlayer = {k: v[0] for k, v in tp["layers"][0].items()}
    xin = _np(8, 2, 40, tcfg.d_model)                      # ragged: 40 / 16
    want = jssm.ssm_mixer(jcfg, jlayer, jnp.asarray(xin),
                          use_kernel=use_kernel)
    ops.reset_counts()
    got = tssm.ssm_mixer(tcfg, tlayer, torch.from_numpy(xin),
                         use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert ops.plain_calls()["ssd_scan"] == int(use_kernel)


# ---------------------------------------------------------------------------
# Member forward
@pytest.mark.parametrize("name", MEMBERS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(members, name, use_kernel):
    jcfg, tcfg, jp, tp = members[name]
    X = np.random.default_rng(9).integers(0, jcfg.vocab_size, (3, 40)
                                          ).astype(np.int32)
    want, _ = M.forward(jp, jcfg, jnp.asarray(X), use_kernel=use_kernel)
    ops.reset_counts()
    got, aux = TM.forward(tp, tcfg, torch.from_numpy(X),
                          use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert aux == 0.0
    # every SSM or hybrid layer runs the scan entry, every hybrid layer the
    # flash entry; mamba2 has no attention at all
    calls = ops.plain_calls()
    assert calls["ssd_scan"] == (tcfg.num_layers if use_kernel else 0)
    hybrid = tcfg.num_heads if name.startswith("hymba") else 0
    assert calls["flash_attention"] == (
        tcfg.num_layers if use_kernel and hybrid else 0)


@pytest.mark.parametrize("name", MEMBERS)
def test_bridge_carries_the_ssm_leaves(members, name):
    _, _, jp, tp = members[name]
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for leaf in SSM_LEAVES:
            a = np.asarray(jl[leaf])
            assert tl[leaf].dtype == torch.float32
            np.testing.assert_array_equal(tl[leaf].numpy(), a)
    assert TM.param_shapes(get_config(name)) == \
        tquant.tree_map(lambda t: tuple(t.shape), tp)


def test_int8_ssm_leaves_match_jax_codes(members):
    """The int8 tree quantizes conv_w (repeats, d_conv, C) and every
    (repeats, n) vector, A_log and dt_bias included, one scale per repeat,
    exactly as the JAX package does."""
    _, _, jp, tp = members["mamba2-1.3b-reduced"]
    jq = jquant.quantize_params(jp["layers"][0], "int8")
    tq = tquant.quantize_params(tp["layers"][0], "int8")
    for leaf in SSM_LEAVES:
        assert set(tq[leaf]) == {"q", "s"}, leaf
        np.testing.assert_array_equal(tq[leaf]["q"].numpy(),
                                      np.asarray(jq[leaf]["q"]))
        np.testing.assert_allclose(tq[leaf]["s"].numpy(),
                                   np.asarray(jq[leaf]["s"]), rtol=1e-7)
    assert tuple(tq["A_log"]["s"].shape) == (tp["layers"][0]["A_log"].shape[0],
                                             1)


@pytest.mark.parametrize("name", MEMBERS)
def test_int8_member_lazy_forward_equals_dequantized_tree(members, name):
    """The per-layer lazy ``leaf()`` dequantization serves the SSM leaves:
    the forward of the int8 tree equals the forward of its dequantized copy,
    and both match the JAX package's dequantized forward."""
    jcfg, tcfg, jp, tp = members[name]
    X = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 24)
                                           ).astype(np.int32)
    q = tquant.quantize_params(tp, "int8")
    lazy, _ = TM.forward(q, tcfg, torch.from_numpy(X), use_kernel=True)
    full, _ = TM.forward(tquant.dequantize_params(q), tcfg,
                         torch.from_numpy(X))
    np.testing.assert_allclose(lazy.numpy(), full.numpy(), atol=1e-5)
    want, _ = M.forward(jquant.dequantize_params(
        jquant.quantize_params(jp, "int8")), jcfg, jnp.asarray(X))
    np.testing.assert_allclose(lazy.numpy(), np.asarray(want), atol=1e-4)
