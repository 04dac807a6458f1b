"""Member forward of the PyTorch port against ``repro.models.forward``, with
the JAX package's parameters bridged through numpy.  JAX's ``use_kernel``
path runs its Pallas flash kernel in interpret mode; the port's runs the
plain version of its Hopper kernel on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import param_shapes as jparam_shapes  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import ensemble, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving.worker import make_predict_fn  # noqa: E402

SEQ = 16


@pytest.fixture(scope="module")
def ens2():
    jcfgs = jensemble("ENS4")[:2]
    tcfgs = ensemble("ENS4")[:2]
    rng = jax.random.PRNGKey(0)
    jparams = [M.init_params(jax.random.fold_in(rng, i), c)
               for i, c in enumerate(jcfgs)]
    tparams = [TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                    "cpu") for p in jparams]
    return jcfgs, tcfgs, jparams, tparams


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, SEQ)
                                                ).astype(np.int32)


def test_configs_are_copies():
    for j, t in zip(jensemble("ENS12"), ensemble("ENS12")):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("member", [0, 1])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(ens2, member, use_kernel):
    jcfgs, tcfgs, jparams, tparams = ens2
    X = _tokens(4, seed=member)
    want, _ = M.forward(jparams[member], jcfgs[member], jnp.asarray(X),
                        use_kernel=use_kernel)
    ops.reset_counts()
    got, aux = TM.forward(tparams[member], tcfgs[member], torch.from_numpy(X),
                          use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert aux == 0.0
    # use_kernel routes every attention layer through the kernel entry
    calls = ops.plain_calls()["flash_attention"]
    assert calls == (tcfgs[member].num_layers if use_kernel else 0)


def test_param_shapes_match_jax():
    for cfg in (get_config("qwen3-1.7b"), *ensemble("ENS12")):
        assert TM.param_shapes(cfg) == jparam_shapes(cfg)


def test_init_params_layout_and_statistics():
    cfg = ensemble("ENS4")[0]
    p = TM.init_params(cfg, seed=0, device="cpu")
    shapes = tq.tree_map(lambda t: tuple(t.shape), p)
    assert shapes == TM.param_shapes(cfg)
    assert float(p["final_norm"].abs().max()) == 0.0
    wq = p["layers"][0]["wq"]
    assert abs(float(wq.std()) - 0.02) < 2e-3
    again = TM.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"][0]["wq"], wq)


def test_init_params_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        TM.init_params(ensemble("ENS4")[0], seed=0)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m-reduced",
                                  "mamba2-1.3b-reduced",
                                  "hymba-1.5b-reduced",
                                  "llama-3.2-vision-11b-reduced"])
def test_unported_layer_kinds_raise(name):
    cfg = get_config(name)
    p = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.forward(p, cfg, torch.zeros((1, 8), dtype=torch.int32))


def test_sliding_window_member_matches_jax():
    jcfg = jensemble("ENS4")[2]                     # gemma3 (SWA + global)
    tcfg = ensemble("ENS4")[2]
    jp = M.init_params(jax.random.PRNGKey(3), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    X = np.random.default_rng(3).integers(0, 512, (2, 80)).astype(np.int32)
    want, _ = M.forward(jp, jcfg, jnp.asarray(X))
    for use_kernel in (False, True):
        got, _ = TM.forward(tp, tcfg, torch.from_numpy(X),
                            use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_layers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6)
    pos = np.arange(6)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5)


def test_chunked_attention_matches_dense():
    from repro_torch.models import attention as A
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 40, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    pos = torch.arange(40)
    for window in (0, 8):
        dense = A.dense_attention(q, k, v, pos, pos, causal=True,
                                  window=window)
        chunked = A.chunked_attention(q, k, v, pos, pos, causal=True,
                                      window=window, chunk=16)
        np.testing.assert_allclose(chunked.numpy(), dense.numpy(), atol=1e-5)


@pytest.mark.parametrize("member_dtype", ["fp32", "int8"])
def test_predict_fn_is_last_position_of_forward(ens2, member_dtype):
    """The serving fn applies the norm and head to the last position only;
    that equals slicing the full logits.  A quantized member's lazily
    dequantized forward equals the forward of the dequantized tree."""
    _, tcfgs, _, tparams = ens2
    cfg = tcfgs[0]
    params = tparams[0] if member_dtype == "fp32" else \
        tq.quantize_params(tparams[0], member_dtype)
    full = tparams[0] if member_dtype == "fp32" else \
        tq.dequantize_params(params)
    X = torch.from_numpy(_tokens(3, seed=7))
    got = make_predict_fn(cfg, member_dtype=member_dtype)(params, X)
    want, _ = TM.forward(full, cfg, X)
    np.testing.assert_allclose(got.numpy(),
                               want[:, -1, :cfg.vocab_size].numpy(),
                               atol=1e-5)
    q, s = make_predict_fn(cfg, member_dtype=member_dtype,
                           quant_out=True)(params, X)
    assert q.dtype == torch.int8 and tuple(s.shape) == (3, 1)
