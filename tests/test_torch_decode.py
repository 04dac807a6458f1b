"""The port's generation path against the JAX package's on the same numpy
inputs and the same parameters: the decode-attention kernel entry, the KV
quantization, ``init_cache``, ``prefill`` and ``decode_step`` for every
architecture the port serves.

On the CPU the port's ``decode_attention`` wrapper runs its plain version;
the JAX side runs its Pallas kernel in interpret mode through
``repro.kernels.ops``, as its own suite does.  Tolerances: the JAX suite's
for the kernel (tests/test_kernels.py), the port's model parity tolerance
1e-4 for logits and caches (tests/test_torch_models.py), and the JAX
suite's decode-against-forward tolerances (tests/test_decode.py,
tests/test_ssm.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402

ARCHS = ["qwen3-1.7b", "llama3-8b", "musicgen-large", "gemma3-1b",
         "h2o-danube-1.8b", "mamba2-1.3b", "hymba-1.5b",
         "granite-moe-3b-a800m", "llama4-scout-17b-a16e",
         "llama-3.2-vision-11b"]
B, S, STEPS, MAX_LEN = 2, 24, 4, 64
ATOL = 1e-4


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernel entry
# ---------------------------------------------------------------------------
def _mask(kind, L):
    if kind == "tail":              # the JAX suite's mask
        return np.arange(L) < L - 7
    if kind == "leading":           # the first tiles all invalid
        return np.arange(L) >= min(600, L - 5)
    return np.random.default_rng(L).random(L) < 0.5   # "random"


DECODE_CASES = [                    # (b, L, h, kv, hd, dtype, mask)
    (2, 64, 4, 2, 32, "float32", "tail"),       # tests/test_kernels.py:38-43
    (1, 300, 8, 2, 80, "float32", "tail"),
    (3, 1024, 4, 1, 128, "float32", "tail"),
    (2, 128, 4, 4, 64, "bfloat16", "tail"),
    (2, 1024, 4, 1, 128, "float32", "leading"),
    (2, 300, 8, 2, 80, "float32", "random"),
    (1, 200, 4, 1, 256, "bfloat16", "random"),
]


@pytest.mark.parametrize("b,L,h,kv,hd,dtype,mask", DECODE_CASES)
def test_decode_attention_matches_jax(b, L, h, kv, hd, dtype, mask):
    q, k, v = _np(4, b, 1, h, hd), _np(5, b, L, kv, hd), _np(6, b, L, kv, hd)
    valid = _mask(mask, L)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 jnp.asarray(valid))
    ops.reset_counts()
    got = ops.decode_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)), torch.from_numpy(valid))
    assert got.dtype == tdt and tuple(got.shape) == (b, 1, h, hd)
    assert ops.plain_calls()["decode_attention"] == 1
    assert ops.kernel_launches()["decode_attention"] == 0
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_decode_attention_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 1, 4, 32))
    k = torch.zeros((1, 8, 2, 32))
    ok = torch.ones(8, dtype=torch.bool)
    dec.decode_attention(q, k, k, ok)
    with pytest.raises(ValueError):                      # H % KV != 0
        dec.decode_attention(torch.zeros((1, 1, 3, 32)), k, k, ok)
    with pytest.raises(ValueError):                      # hd > 256
        big = torch.zeros((1, 8, 2, 320))
        dec.decode_attention(torch.zeros((1, 1, 4, 320)), big, big, ok)
    with pytest.raises(TypeError):
        dec.decode_attention(q.double(), k.double(), k.double(), ok)
    with pytest.raises(TypeError):                       # mask not bool
        dec.decode_attention(q, k, k, ok.int())
    with pytest.raises(ValueError):                      # mask length
        dec.decode_attention(q, k, k, ok[:4])


@pytest.mark.parametrize("resident", [3, 6])
@pytest.mark.parametrize("b,L,h,kv,hd", [
    (16, 2048, 16, 8, 128), (16, 1024, 25, 5, 64), (16, 1024, 4, 1, 256),
    (1, 7, 64, 1, 128), (3, 300, 8, 2, 80)])
def test_split_plan_covers_the_cache(b, L, h, kv, hd, resident):
    """The splits deal the tiles: together they walk every tile once, and
    of any valid prefix of n tiles each split loads floor(n/S) or
    ceil(n/S) (split_tiles mirrors the kernel's loop).  The grid is one
    wave of ``resident`` blocks on each of 132 SMs, or one split."""
    gb, tps, n = dec.split_plan(b, L, h, kv, hd, 132, resident)
    ntiles = -(-L // dec.TILE)
    assert 1 <= gb <= h // kv and gb * hd <= dec.MAX_GROUP_DIMS
    assert (n - 1) * tps < ntiles <= n * tps
    blocks = b * kv * -(-(h // kv) // gb) * n
    assert n == 1 or blocks <= resident * 132
    walks = [list(dec.split_tiles(s, n, ntiles)) for s in range(n)]
    assert sorted(t for w in walks for t in w) == list(range(ntiles))
    assert max(len(w) for w in walks) <= tps
    for prefix in range(ntiles + 1):
        loads = [sum(t < prefix for t in w) for w in walks]
        assert set(loads) <= {prefix // n, -(-prefix // n)}, (prefix, loads)


def test_quantize_kv_matches_jax():
    x = _np(0, 4, 32, 2, 64)
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    tq, ts = tquant.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (4, 32, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(tquant.dequantize_kv(tq, ts).numpy(),
                               np.asarray(jquant.dequantize_kv(jq, js)),
                               rtol=1e-7)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch, quantized):
    """Shapes and dtypes at a served size (no memory: JAX's structs, the
    port's meta tensors), and zeros at a reduced one."""
    want = jcache.cache_struct(jget_config(arch), 16, 2048,
                               quantized=quantized)
    got = TM.init_cache(get_config(arch), 16, 2048, quantized=quantized,
                        device="meta")
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert sorted(g) == sorted(w)
        for name in w:
            assert tuple(g[name].shape) == w[name].shape
            assert str(g[name].dtype).split(".")[-1] == str(w[name].dtype)
    small = TM.init_cache(get_config(arch).reduced(), 2, 8,
                          quantized=quantized, device="cpu")
    assert not any(t.any() for e in small["layers"] for t in e.values())


# ---------------------------------------------------------------------------
# prefill + decode_step
# ---------------------------------------------------------------------------
_jit_decode = jax.jit(M.decode_step, static_argnums=(1,),
                      static_argnames=("use_kernel",))


@pytest.fixture(scope="module")
def models():
    """Reduced config, JAX parameters and the same parameters in the port,
    per architecture, built on first use."""
    built = {}

    def get(arch, **replace):
        key = (arch, tuple(sorted(replace.items())))
        if key not in built:
            jcfg = dataclasses.replace(jget_config(arch).reduced(), **replace)
            tcfg = dataclasses.replace(get_config(arch).reduced(), **replace)
            jp = M.init_params(jax.random.PRNGKey(0), jcfg)
            tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      "cpu")
            built[key] = (jcfg, tcfg, jp, tp)
        return built[key]
    return get


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)
                                                ).astype(np.int32)


def _frontend(cfg):
    """A cross-attention member's frontend (B, F, fdim), nonzero (a zero
    one projects to k = v = 0): one seeded row, repeated.  None for the
    other members."""
    if not cfg.frontend_tokens:
        return None
    row = np.random.default_rng(77).standard_normal(
        (1, cfg.frontend_tokens, cfg.fdim)).astype(np.float32)
    return np.repeat(row, B, axis=0)


def _jax_generate(jcfg, jp, X, use_kernel, quantize_cache=False):
    """JAX prefill + decode steps teacher-forced on X: the logits and the
    cache after prefill."""
    fe = _frontend(jcfg)
    lg, cache = M.prefill(jp, jcfg, jnp.asarray(X[:, :S]), MAX_LEN,
                          None if fe is None else jnp.asarray(fe),
                          use_kernel=use_kernel, quantize_cache=quantize_cache)
    logits, first = [np.asarray(lg)], jax.tree_util.tree_map(np.asarray, cache)
    for t in range(STEPS):
        lg, cache = _jit_decode(jp, jcfg, cache,
                                jnp.asarray(X[:, S + t:S + t + 1]),
                                jnp.int32(S + t), use_kernel=use_kernel)
        logits.append(np.asarray(lg))
    return logits, first


def _port_generate(tcfg, tp, X, use_kernel, quantize_cache=False):
    fe = _frontend(tcfg)
    lg, cache = TM.prefill(tp, tcfg, torch.from_numpy(X[:, :S]), MAX_LEN,
                           None if fe is None else torch.from_numpy(fe),
                           use_kernel=use_kernel,
                           quantize_cache=quantize_cache)
    first = [{n: t.clone() for n, t in e.items()} for e in cache["layers"]]
    logits = [lg.numpy()]
    for t in range(STEPS):
        lg, again = TM.decode_step(tp, tcfg, cache,
                                   torch.from_numpy(X[:, S + t:S + t + 1]),
                                   S + t, use_kernel=use_kernel)
        assert again is cache                   # updated in place
        logits.append(lg.numpy())
    return logits, first, cache


def _attention_layers(cfg):
    return sum(k in ("attn", "swa", "hybrid") for k in cfg.pattern) * \
        cfg.repeats


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax(models, arch, use_kernel):
    jcfg, tcfg, jp, tp = models(arch)
    X = _tokens(tcfg, S + STEPS)
    want, want_cache = _jax_generate(jcfg, jp, X, use_kernel)
    ops.reset_counts()
    got, got_cache, _ = _port_generate(tcfg, tp, X, use_kernel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    for g, w in zip(got_cache, want_cache["layers"]):
        assert sorted(g) == sorted(w)
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], atol=ATOL,
                                       err_msg=f"{arch} cache {name}")
    # use_kernel routes every attention layer of every step through the
    # kernel entry (its plain version here); the plain path never does
    calls = ops.plain_calls()["decode_attention"]
    assert calls == (_attention_layers(tcfg) * STEPS if use_kernel else 0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_swa_ring_buffer_wraps(models, use_kernel):
    """danube with a 16-slot window: 8 prompt tokens and 32 steps, held to
    the JAX forward as tests/test_decode.py holds the JAX decode."""
    jcfg, tcfg, jp, tp = models("h2o-danube-1.8b", sliding_window=16)
    total, s0 = 40, 8
    X = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, total)
                                          ).astype(np.int32)
    full, _ = M.forward(jp, jcfg, jnp.asarray(X))
    full = np.asarray(full)
    _, cache = TM.prefill(tp, tcfg, torch.from_numpy(X[:, :s0]), 64,
                          use_kernel=use_kernel)
    assert cache["layers"][0]["k"].shape[2] == 16
    for t in range(s0, total):
        lg, cache = TM.decode_step(tp, tcfg, cache,
                                   torch.from_numpy(X[:, t:t + 1]), t,
                                   use_kernel=use_kernel)
        np.testing.assert_allclose(lg.numpy(), full[:, t], atol=1e-3)


def test_mamba2_decode_long_run(models):
    """48 steps past an 8-token prompt (tests/test_ssm.py:50-67): the state
    is all the cache holds, and the logits follow the JAX forward."""
    jcfg, tcfg, jp, tp = models("mamba2-1.3b")
    total = 48
    X = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, total)
                                          ).astype(np.int32)
    full = np.asarray(M.forward(jp, jcfg, jnp.asarray(X))[0])
    _, cache = TM.prefill(tp, tcfg, torch.from_numpy(X[:, :8]), 8,
                          use_kernel=True)
    for t in range(8, total):
        lg, cache = TM.decode_step(tp, tcfg, cache,
                                   torch.from_numpy(X[:, t:t + 1]), t)
        np.testing.assert_allclose(lg.numpy(), full[:, t], atol=2e-3)
    for entry in cache["layers"]:
        assert set(entry) == {"h", "conv"}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b", "hymba-1.5b",
                                  "llama-3.2-vision-11b"])
def test_int8_kv_cache_matches_jax(models, arch):
    """The int8 cache takes the plain path even with ``use_kernel``; the
    logits and the int8 codes follow the JAX package's."""
    jcfg, tcfg, jp, tp = models(arch)
    X = _tokens(tcfg, S + STEPS, seed=2)
    want, want_cache = _jax_generate(jcfg, jp, X, True, quantize_cache=True)
    ops.reset_counts()
    got, got_cache, cache = _port_generate(tcfg, tp, X, True,
                                           quantize_cache=True)
    assert ops.plain_calls()["decode_attention"] == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    for g, w in zip(got_cache, want_cache["layers"]):
        assert sorted(g) == sorted(w)
        for name in ("k", "v"):
            assert g[name].dtype == torch.int8
            # an element on a rounding edge may take the next code
            diff = np.abs(g[name].numpy().astype(int) - w[name].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            np.testing.assert_allclose(g[name + "_scale"].numpy(),
                                       w[name + "_scale"], rtol=1e-4)
    for e in cache["layers"]:
        assert e["k"].dtype == torch.int8 and e["v"].dtype == torch.int8


def test_decode_past_the_cache_raises(models):
    """An ATTN cache has no slot past max_len (the JAX package silently
    overwrites its last slot there); the cache is left as it was."""
    _, tcfg, _, tp = models("qwen3-1.7b")
    X = torch.from_numpy(_tokens(tcfg, 8))
    _, cache = TM.prefill(tp, tcfg, X, 8)
    before = cache["layers"][0]["k"].clone()
    with pytest.raises(ValueError):
        TM.decode_step(tp, tcfg, cache, X[:, :1], 8)
    assert torch.equal(cache["layers"][0]["k"], before)
    with pytest.raises(ValueError):
        TM.prefill(tp, tcfg, X, 4)


def test_capacity_moe_generation_matches_jax():
    """granite with the capacity dispatch (the full config's ``impl``) at
    reduced widths: prefill groups the prompt's B*S tokens and each decode
    step the batch's B tokens, in the JAX package and the port alike."""
    from repro.configs.base import MoEConfig as JMoE
    from repro_torch.configs.base import MoEConfig as TMoE
    jcfg = jget_config("granite-moe-3b-a800m").reduced()
    tcfg = get_config("granite-moe-3b-a800m").reduced()
    jcfg = dataclasses.replace(jcfg, moe=JMoE(**{
        **dataclasses.asdict(jcfg.moe), "impl": "capacity",
        "capacity_factor": 0.5}))
    tcfg = dataclasses.replace(tcfg, moe=TMoE(**{
        **dataclasses.asdict(tcfg.moe), "impl": "capacity",
        "capacity_factor": 0.5}))
    jp = M.init_params(jax.random.PRNGKey(8), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    X = _tokens(tcfg, S + STEPS, seed=8)
    want, _ = _jax_generate(jcfg, jp, X, False)
    got, _, _ = _port_generate(tcfg, tp, X, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_cross_layer_caches_the_frontend(models):
    """prefill stores the frontend's projected keys and values as the
    cross layer's cache (decode reads them at every step); without a
    frontend it raises."""
    jcfg, tcfg, _, tp = models("llama-3.2-vision-11b")
    X = _tokens(tcfg, S)
    fe = torch.from_numpy(_frontend(tcfg))
    _, cache = TM.prefill(tp, tcfg, torch.from_numpy(X), MAX_LEN, fe)
    i = tcfg.pattern.index("cross")
    entry = cache["layers"][i]
    lp = {k: v[0] for k, v in tp["layers"][i].items()}
    from repro_torch.models import attention as A
    _, k, v = A.project_qkv(tcfg, lp, torch.zeros((B, 1, tcfg.d_model)),
                            kv_src=fe)
    assert entry["k"].shape[2] == tcfg.frontend_tokens
    torch.testing.assert_close(entry["k"][0], k)
    torch.testing.assert_close(entry["v"][0], v)
    assert entry["k"].abs().max() > 0
    with pytest.raises(ValueError, match="frontend"):
        TM.prefill(tp, tcfg, torch.from_numpy(X), MAX_LEN)


def test_init_cache_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        TM.init_cache(get_config("qwen3-1.7b-reduced"), 1, 8)
