"""Kernel entries of the PyTorch port against the JAX package's.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode through ``repro.kernels.ops``.  Inputs
are made with numpy from a seed and fed to both.  Tolerances are the JAX
suite's (tests/test_kernels.py, tests/test_quantized.py)."""
import subprocess
import sys
import textwrap

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
    ops.dense(torch.zeros((1, 2, 4)), torch.zeros((4, 4)), "bsd,de->bse")
    ops.reset_counts()
    assert not any(ops.plain_calls().values())
    assert not any(ops.kernel_launches().values())
    assert not any(ops.library_calls().values())


def test_pow2_clamp_matches_jax():
    for n in (1, 2, 3, 7, 8, 9, 100, 129):
        assert ops.pow2_clamp(n, 8, 64) == jops.pow2_clamp(n, 8, 64)


# ---------------------------------------------------------------------------
# dense: the SSM mixer's two projections (no JAX counterpart: the JAX
# package leaves its products to XLA, so the call site's einsum is the
# reference, bit for bit wherever the kernel does not take the product)

DENSE_CASES = [                # (x shape, w shape, eq)
    ((2, 16, 32), (32, 48), "bsd,de->bse"),      # in_proj's form
    ((2, 16, 48), (48, 32), "bse,ed->bsd"),      # out_proj's form
    ((3, 7, 20), (20, 12), "bsd,de->bse"),       # a few rows
    ((1, 5, 6), (6, 10), "bsd,de->bse"),         # K and N not multiples of 4
]


def _routes(use_kernel=True):
    return {"launches": ops.kernel_launches()["gemm_tf32x3"],
            "library": ops.library_calls()["dense"],
            "plain": ops.plain_calls()["gemm_tf32x3"]}


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("xs,ws,eq", DENSE_CASES)
def test_dense_is_the_einsum_bit_for_bit_on_the_cpu(xs, ws, eq, use_kernel):
    x, w = torch.from_numpy(_np(1, *xs)), torch.from_numpy(_np(2, *ws))
    ops.reset_counts()
    got = ops.dense(x, w, eq, use_kernel=use_kernel)
    assert torch.equal(got, torch.einsum(eq, x, w))
    assert _routes() == {"launches": 0, "library": 1, "plain": 0}
    assert not any(ops.plain_calls().values())


def test_dense_with_grad_on_is_the_einsum_and_its_gradients():
    x0, w0 = torch.from_numpy(_np(3, 2, 8, 16)), torch.from_numpy(_np(4, 16, 8))
    x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    xr, wr = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    ops.reset_counts()
    got = ops.dense(x, w, "bsd,de->bse", use_kernel=True)
    want = torch.einsum("bsd,de->bse", xr, wr)
    assert torch.equal(got, want)
    (got * got).sum().backward()
    (want * want).sum().backward()
    assert torch.equal(x.grad, xr.grad) and torch.equal(w.grad, wr.grad)
    assert _routes() == {"launches": 0, "library": 1, "plain": 0}


def test_dense_on_a_one_rank_mesh_is_the_collectives_einsum(tmp_path):
    """DTensor operands (a 1 x 1 gloo mesh, ``in_proj`` sharded on its
    columns over "model" as the sharded steps place it) take the call
    site's DTensor einsum, whatever ``use_kernel`` says."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, "src")
        import torch, torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel.collectives import einsum
        dist.init_process_group("gloo", init_method="file://{tmp_path}/pg",
                                rank=0, world_size=1)
        mesh = make_host_mesh(1, 1)
        g = torch.Generator().manual_seed(0)
        x = torch.randn((2, 8, 16), generator=g)
        w = torch.randn((16, 12), generator=g)
        xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        wd = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
        out = {{}}
        for use_kernel in (True, False):
            ops.reset_counts()
            got = ops.dense(xd, wd, "bsd,de->bse", use_kernel=use_kernel)
            want = einsum("bsd,de->bse", xd, wd)
            out[str(use_kernel)] = {{
                "dtensor": type(got).__name__,
                "equal": bool(torch.equal(got.full_tensor(),
                                          want.full_tensor())),
                "plain_equal": bool(torch.equal(
                    got.full_tensor(), torch.einsum("bsd,de->bse", x, w))),
                "launches": ops.kernel_launches()["gemm_tf32x3"],
                "library": ops.library_calls()["dense"],
                "plain": sum(ops.plain_calls().values())}}
        dist.destroy_process_group()
        print(json.dumps(out))
    """)
    root = __file__.rsplit("/tests", 1)[0]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    got = __import__("json").loads(res.stdout.strip().splitlines()[-1])
    for use_kernel in ("True", "False"):
        assert got[use_kernel] == {"dtensor": "DTensor", "equal": True,
                                   "plain_equal": True, "launches": 0,
                                   "library": 1, "plain": 0}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


ROUTE_CASES = [                # (B, S, K, N, takes the kernel)
    (16, 256, 2048, 8512, True),      # mamba2 in_proj, a 16-row chunk
    (8, 256, 2048, 8512, True),       # ... an 8-row chunk
    (16, 256, 4096, 2048, True),      # mamba2 out_proj
    (8, 256, 4096, 2048, True),
    (16, 256, 3200, 1600, True),      # hymba out_proj
    (16, 256, 1600, 6482, False),     # hymba in_proj: N % 4 != 0
    (8, 256, 2046, 2048, False),      # K % 4 != 0
    (16, 1, 2048, 8512, False),       # one decode token a row
    (1, 4096, 2048, 8512, True),      # a long prefill row
]


@pytest.mark.parametrize("b,s,k,n,want", ROUTE_CASES)
def test_dense_rule_sends_the_served_shapes_to_the_kernel(monkeypatch, b, s,
                                                          k, n, want):
    """The shape rule on operands taken as lying on the card (meta tensors
    stand in for them: nothing is computed)."""
    from repro_torch.kernels import gemm_tf32x3 as gemm
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    x, w = _meta(b, s, k), _meta(k, n)
    assert ops.dense_takes_kernel(x, w, "bsd,de->bse", True) is want
    assert gemm.takes(b * s, k, n) is want
    assert not ops.dense_takes_kernel(x, w, "bsd,de->bse", False)


def test_dense_rule_leaves_the_rest_to_the_library(monkeypatch):
    from repro_torch.kernels import gemm_tf32x3 as gemm
    b, s, k, n = 16, 256, 2048, 8512
    x, w = _meta(b, s, k), _meta(k, n)
    assert not ops.dense_takes_kernel(x, w, "bsd,de->bse", True)   # not on
    monkeypatch.setattr(ops, "_on_card", lambda t: True)           # a card
    eq = "bsd,de->bse"
    assert ops.dense_takes_kernel(x, w, eq, True)
    rows = gemm.MIN_ROWS
    assert ops.dense_takes_kernel(_meta(1, rows, k), w, eq, True)
    assert not ops.dense_takes_kernel(_meta(1, rows - 1, k), w, eq, True)
    assert not ops.dense_takes_kernel(x.bfloat16(), w.bfloat16(), eq, True)
    assert not ops.dense_takes_kernel(x, _meta(n, k).t(), eq, True)
    assert not ops.dense_takes_kernel(x.transpose(0, 1), w, eq, True)
    assert not ops.dense_takes_kernel(x, _meta(k, n)[:, :n - 4], eq, True)
    assert not ops.dense_takes_kernel(x, w, "bsd,de->bes", True)
    assert not ops.dense_takes_kernel(x, w, "bsd,dd->bsd", True)
    assert not ops.dense_takes_kernel(x, _meta(1, k, n), eq, True)
    with torch.enable_grad():
        assert not ops.dense_takes_kernel(x.requires_grad_(True), w, eq, True)
        with torch.no_grad():
            assert ops.dense_takes_kernel(x, w, eq, True)


def test_gemm_wrapper_runs_the_plain_version_on_the_cpu():
    from repro_torch.kernels import gemm_tf32x3 as gemm
    x, w = torch.from_numpy(_np(6, 12, 8)), torch.from_numpy(_np(7, 8, 20))
    ops.reset_counts()
    assert torch.equal(gemm.gemm_tf32x3(x, w), x @ w)
    assert _routes() == {"launches": 0, "library": 0, "plain": 1}
    with pytest.raises(ValueError):
        gemm.gemm_tf32x3(x, w[:7])
    with pytest.raises(TypeError):
        gemm.gemm_tf32x3(x.double(), w.double())
    with pytest.raises(RuntimeError, match="no backward"):
        gemm.gemm_tf32x3(x.requires_grad_(True), w)


@pytest.mark.parametrize("name", ["mamba2-1.3b-reduced", "hymba-1.5b-reduced"])
def test_ssm_mixer_sends_both_projections_through_dense(monkeypatch, name):
    """With its operands taken as lying on the card, the mixer's in_proj and
    out_proj go to the kernel entry once each (a stand-in computes them on
    the CPU), the scan to its own entry, no plain GEMM runs, and the output
    is the einsum path's; on the CPU as it is, both are left to the einsum,
    bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import gemm_tf32x3 as gemm
    from repro_torch.models import init_params
    from repro_torch.models.ssm import ssm_mixer
    cfg = get_config(name)
    layer = init_params(cfg, seed=0, device="cpu")["layers"][0]
    p = {k: v[0] for k, v in layer.items()}
    rows = -(-gemm.MIN_ROWS // 64)
    xin = torch.from_numpy(_np(5, rows, 64, cfg.d_model))
    with torch.no_grad():
        ops.reset_counts()
        want = ssm_mixer(cfg, p, xin, use_kernel=False)
        assert _routes() == {"launches": 0, "library": 2, "plain": 0}
        ops.reset_counts()
        same = ssm_mixer(cfg, p, xin, use_kernel=True)
        assert torch.equal(same, want)
        assert _routes() == {"launches": 0, "library": 2, "plain": 0}
        seen = []
        monkeypatch.setattr(ops, "_on_card", lambda t: True)
        monkeypatch.setattr(gemm, "gemm_tf32x3",
                            lambda x, w: seen.append((x.shape, w.shape))
                            or x @ w)
        ops.reset_counts()
        got = ssm_mixer(cfg, p, xin, use_kernel=True)
    m = rows * 64
    di, n = cfg.d_inner, cfg.ssm.d_state
    assert seen == [((m, cfg.d_model), (cfg.d_model, 2 * di + 2 * n +
                                         cfg.ssm_heads)),
                    ((m, di), (di, cfg.d_model))]
    assert ops.library_calls()["dense"] == 0
    assert ops.plain_calls()["gemm_tf32x3"] == 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
