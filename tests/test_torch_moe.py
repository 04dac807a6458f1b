"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's
on the same numpy inputs and parameters: the router and its tie order, the
load-balance loss, the dense and the capacity dispatch (padding to whole
groups, drops under a tight capacity, the shared expert), the MoE members'
forward and aux loss, and the int8 member's expert leaves.  Tolerance: 1e-5
for the layer, the port's model parity tolerance 1e-4 for logits
(tests/test_torch_models.py).  The JAX suite's own MoE invariants
(tests/test_moe.py) are held on the port too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ATOL = 1e-5
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down", "ws_gate", "ws_up",
              "ws_down")


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfgs(arch="granite-moe-3b-a800m", **moe):
    """The reduced config of ``arch`` with its MoE fields replaced, as the
    JAX package's and the port's."""
    out = []
    for get in (jget_config, get_config):
        cfg = get(arch).reduced()
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def _layer(jcfg, seed=0, scale=0.05):
    """One layer's MoE leaves (no repeats dim) as numpy arrays."""
    shapes = JT._layer_param_shapes(jcfg, "attn")
    return {k: _np(seed + i, *s) * scale for i, (k, s) in
            enumerate(shapes.items()) if k in MOE_LEAVES}


def _both(jcfg, tcfg, lp, x):
    want, jaux = jmoe.moe_ffn(jcfg, {k: jnp.asarray(v) for k, v in lp.items()},
                              jnp.asarray(x))
    got, taux = tmoe.moe_ffn(tcfg, {k: torch.from_numpy(v)
                                    for k, v in lp.items()},
                             torch.from_numpy(x))
    return np.asarray(want), float(jaux), got.numpy(), float(taux)


# (arch, impl, capacity factor, batch, seq): padding, drops, the shared expert
MOE_CASES = [
    ("granite-moe-3b-a800m", "dense", 1.25, 2, 24),
    ("granite-moe-3b-a800m", "capacity", 1.25, 2, 24),
    ("granite-moe-3b-a800m", "capacity", 1.25, 3, 200),   # T 600: padded
    ("granite-moe-3b-a800m", "capacity", 1.25, 1, 1100),  # T 1100: 3 groups
    ("granite-moe-3b-a800m", "capacity", 0.25, 2, 64),    # tight: drops
    ("granite-moe-3b-a800m", "capacity", 0.25, 3, 200),   # drops and pads
    ("llama4-scout-17b-a16e", "dense", 1.25, 2, 24),      # shared expert
    ("llama4-scout-17b-a16e", "capacity", 1.25, 2, 300),
]


@pytest.mark.parametrize("arch,impl,cf,b,s", MOE_CASES)
def test_moe_ffn_matches_jax(arch, impl, cf, b, s):
    jcfg, tcfg = _cfgs(arch, impl=impl, capacity_factor=cf)
    lp = _layer(jcfg, seed=3)
    want, jaux, got, taux = _both(jcfg, tcfg, lp, _np(7, b, s, jcfg.d_model))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert abs(jaux - taux) < 1e-6


def test_capacity_drops_tokens_as_jax_does():
    """Under a tight capacity some (token, k) assignments are dropped, the
    same ones in both: the port's kept set reproduces the JAX output and
    differs from the dropless one."""
    jcfg, tcfg = _cfgs(impl="capacity", capacity_factor=0.25)
    x = _np(8, 2, 64, jcfg.d_model)
    lp = _layer(jcfg, seed=5)
    t = x.shape[0] * x.shape[1]
    g, ng, cap = tmoe.capacity_plan(tcfg, t)
    assert (g, ng) == (128, 1)
    assert cap == max(1, int(0.25 * tcfg.moe.top_k * g / tcfg.moe.num_experts))
    _, idx, _ = tmoe._router(torch.from_numpy(x).reshape(t, -1),
                             torch.from_numpy(lp["router"]), tcfg.moe.top_k)
    pos, keep = tmoe.dispatch_slots(idx.reshape(ng, g, -1),
                                    tcfg.moe.num_experts, cap)
    assert 0 < int((~keep).sum()) < keep.numel()
    # every expert takes at most cap assignments, in slots 0..cap-1
    for e in range(tcfg.moe.num_experts):
        taken = pos[keep & (idx.reshape(ng, g, -1) == e)]
        assert sorted(taken.tolist()) == list(range(len(taken)))
        assert len(taken) <= cap
    want, _, got, _ = _both(jcfg, tcfg, lp, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    dense, _, _, _ = _both(*_cfgs(impl="dense"), lp, x)
    assert np.abs(got - dense).max() > 1e-4


@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("capacity", 1.25),
                                     ("capacity", 0.25)])
def test_router_ties_take_the_lower_expert(impl, cf):
    """All-zero router weights: every probability ties.  ``lax.top_k``
    gives the lower expert index first; so does the port, and the capacity
    dispatch then fills and drops the same slots."""
    jcfg, tcfg = _cfgs(impl=impl, capacity_factor=cf)
    lp = _layer(jcfg, seed=11)
    lp["router"] = np.zeros_like(lp["router"])
    x = _np(12, 2, 40, jcfg.d_model)
    jw, jidx, _ = jmoe._router(jnp.asarray(x.reshape(80, -1)),
                               jnp.asarray(lp["router"]), jcfg.moe.top_k)
    tw, tidx, _ = tmoe._router(torch.from_numpy(x.reshape(80, -1)),
                               torch.from_numpy(lp["router"]),
                               tcfg.moe.top_k)
    assert (np.asarray(jidx) == np.arange(jcfg.moe.top_k)).all()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)
    want, jaux, got, taux = _both(jcfg, tcfg, lp, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert abs(jaux - taux) < 1e-6


def test_router_matches_jax():
    x, w = _np(1, 32, 16), _np(2, 16, 8) * 0.1
    jw, jidx, jp = jmoe._router(jnp.asarray(x), jnp.asarray(w), 3)
    tw, tidx, tp = tmoe._router(torch.from_numpy(x), torch.from_numpy(w), 3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "uniform", "collapsed"])
def test_load_balance_loss_matches_jax(kind):
    E, T, k = 8, 1024, 2
    rng = np.random.default_rng(0)
    if kind == "random":
        logits = rng.standard_normal((T, E)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        idx = np.argsort(-probs, axis=-1)[:, :k]
    elif kind == "uniform":
        probs = np.full((T, E), 1.0 / E, np.float32)
        idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    else:
        probs = np.zeros((T, E), np.float32)
        probs[:, 0] = 1.0
        idx = np.zeros((T, k), np.int64)
    want = float(jmoe.load_balance_loss(jnp.asarray(probs),
                                        jnp.asarray(idx), E))
    got = float(tmoe.load_balance_loss(torch.from_numpy(probs),
                                       torch.from_numpy(idx), E))
    assert abs(got - want) < 1e-5


# --- the JAX suite's invariants (tests/test_moe.py), held on the port -------
def test_capacity_matches_dense_when_ample():
    _, tcfg = _cfgs(impl="dense")
    ample = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, impl="capacity",
        capacity_factor=float(tcfg.moe.num_experts)))
    lp = {k: torch.from_numpy(v) for k, v in _layer(_cfgs()[0]).items()}
    x = torch.from_numpy(_np(5, 2, 24, tcfg.d_model))
    out_d, aux_d = tmoe.moe_ffn(tcfg, lp, x)
    out_c, aux_c = tmoe.moe_ffn(ample, lp, x)
    np.testing.assert_allclose(out_d.numpy(), out_c.numpy(), atol=ATOL)
    assert abs(float(aux_d) - float(aux_c)) < 1e-6


def test_shared_expert_always_on():
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    assert cfg.moe.shared_expert and cfg.moe.top_k == 1
    lp = {k: torch.from_numpy(v) for k, v in
          _layer(jget_config("llama4-scout-17b-a16e").reduced()).items()}
    x = torch.from_numpy(_np(4, 1, 8, cfg.d_model))
    with_shared, _ = tmoe.moe_ffn(cfg, lp, x)
    without, _ = tmoe.moe_ffn(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, shared_expert=False)), lp, x)
    assert (with_shared - without).abs().max() > 1e-4


# --- members ---------------------------------------------------------------
@pytest.mark.parametrize("arch,impl", [("granite-moe-3b-a800m", "dense"),
                                       ("granite-moe-3b-a800m", "capacity"),
                                       ("llama4-scout-17b-a16e", "dense"),
                                       ("llama4-scout-17b-a16e", "capacity")])
def test_forward_and_aux_loss_match_jax(arch, impl):
    """The member forward's logits and its aux loss, the sum of the layers'
    load-balance losses, at 400 tokens a row: with ``capacity`` the rows
    share groups of 512 tokens."""
    jcfg, tcfg = _cfgs(arch, impl=impl)
    jp = M.init_params(jax.random.PRNGKey(3), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    X = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 400)
                                          ).astype(np.int32)
    want, jaux = M.forward(jp, jcfg, jnp.asarray(X))
    got, taux = TM.forward(tp, tcfg, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(jaux) > 0
    assert abs(float(taux) - float(jaux)) < 1e-6


def test_int8_member_dequantizes_its_expert_leaves_per_layer():
    """The int8 member's 4-D expert leaves (repeats, E, d, f) and its router
    carry one scale per last-axis slice; ``leaf`` dequantizes one repeat to
    the values of JAX's whole-tree ``dequantize_params``, and the forward on
    the wrapped tree equals the forward on JAX's dequantized one."""
    jcfg, tcfg = _cfgs()
    jp = M.init_params(jax.random.PRNGKey(6), jcfg)
    jdq = jquant.dequantize_params(jquant.quantize_params(jp, "int8"))
    tq = tquant.quantize_params(
        TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        "int8")
    layer = tq["layers"][0]
    assert layer["w_gate"]["q"].dtype == torch.int8
    assert tuple(layer["w_gate"]["s"].shape) == \
        jp["layers"][0]["w_gate"].shape[:-1] + (1,)
    for name in ("router", "w_gate", "w_up", "w_down"):
        for r in range(tcfg.repeats):
            np.testing.assert_allclose(
                tquant.leaf(layer[name], r).numpy(),
                np.asarray(jdq["layers"][0][name][r]), atol=1e-7)
    X = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16)
                                          ).astype(np.int32)
    want, _ = M.forward(jdq, jcfg, jnp.asarray(X))
    got, _ = TM.forward(tq, tcfg, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
