"""Training in the PyTorch port, ported from tests/test_training.py
(convergence, grad accumulation, remat, schedule, clipping, checkpoints, the
data pipeline), plus its parity with the JAX package on the same numpy
inputs: the loss and every gradient leaf against ``jax.value_and_grad``,
``optimizer.apply`` on the same gradients, the schedule, the data batches,
checkpoints restored across the two packages, and both packages refusing to
differentiate through their kernels."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import tokenizer as jtok  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtrain_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import tokenizer as tok  # noqa: E402
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import ensemble_combine as tcomb  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from repro_torch.training.train_loop import (loss_and_grads,  # noqa: E402
                                             make_train_step, train)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops; beside the suite's other workers,
    torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clone(tree):
    return T.unflatten(tree, [t.clone() for t in T.leaves(tree)])


def _bridged(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _max_delta(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(T.leaves(a), T.leaves(b)))


# ---- the cases of tests/test_training.py, on the port ------------------------

def test_loss_decreases_on_ngram():
    cfg = get_config("qwen3-1.7b").reduced()
    params = init_params(cfg, 0, "cpu")
    data = SyntheticLM(cfg.vocab_size, 32, task="ngram").iterator(16, cfg)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=80)
    _, hist = train(cfg, params, data, ocfg, steps=80, log_every=20)
    assert hist[-1]["loss"] < hist[0]["loss"] - 1.0


def test_grad_accum_equivalence():
    cfg = get_config("llama3-8b").reduced()
    params = init_params(cfg, 0, "cpu")
    ocfg = opt.AdamWConfig()
    batch = SyntheticLM(cfg.vocab_size, 16).batch(8)
    p1, p4 = _clone(params), _clone(params)
    s1 = make_train_step(cfg, ocfg, accum_steps=1, remat=False)
    s4 = make_train_step(cfg, ocfg, accum_steps=4, remat=False)
    p1, _, m1 = s1(p1, opt.init(p1), batch)
    p4, _, m4 = s4(p4, opt.init(p4), batch)
    assert abs(float(m1["ce"]) - float(m4["ce"])) < 1e-4
    assert _max_delta(p1, p4) < 1e-4
    # the JAX package's accumulation metrics: ce is the mean loss, aux 0
    assert float(m4["aux"]) == 0.0 and float(m4["ce"]) == float(m4["loss"])


def test_remat_equivalence():
    cfg = get_config("gemma3-1b").reduced()
    params = init_params(cfg, 0, "cpu")
    ocfg = opt.AdamWConfig()
    batch = SyntheticLM(cfg.vocab_size, 16).batch(4)
    pa, pb = _clone(params), _clone(params)
    pa, _, ma = make_train_step(cfg, ocfg, remat=False)(pa, opt.init(pa),
                                                        batch)
    pb, _, mb = make_train_step(cfg, ocfg, remat=True)(pb, opt.init(pb),
                                                       batch)
    assert abs(float(ma["loss"]) - float(mb["loss"])) < 1e-5
    assert _max_delta(pa, pb) < 1e-5


def test_schedule_shape():
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    lrs = [float(opt.schedule(ocfg, s)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9          # warmup rises
    assert abs(lrs[10] - 1e-3) < 1e-4              # peak after warmup
    assert lrs[-1] < 2.0e-4                        # decays toward min ratio
    assert lrs[-1] >= 1e-4 - 1e-9


def test_grad_clip():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    state = opt.init(params)
    ocfg = opt.AdamWConfig(grad_clip=1.0)
    _, _, m = opt.apply(ocfg, params, grads, state)
    assert float(m["grad_norm"]) == pytest.approx(400.0)


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("mamba2-1.3b").reduced()
    params = init_params(cfg, 0, "cpu")
    state = opt.init(params)
    tree = {"params": params, "opt": state}
    ckpt.save(str(tmp_path), 7, tree)
    restored = ckpt.restore(str(tmp_path), tree)
    for a, b in zip(T.leaves(tree), T.leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert isinstance(restored["opt"], opt.AdamWState)
    assert ckpt.latest_step(str(tmp_path)) == 7


def test_checkpoint_prune_and_structure_check(tmp_path):
    cfg = get_config("musicgen-large").reduced()
    params = init_params(cfg, 0, "cpu")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, params, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), params, step=1)      # pruned
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), {"different": params["embed"]})


def test_ngram_task_is_learnable_structure():
    gen = SyntheticLM(64, 32, task="ngram", seed=1)
    b = gen.batch(4)
    assert b["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    # each token has at most 8 successors (sparse bigram)
    succ = {}
    big = gen.batch(64)
    seq = np.concatenate([big["tokens"], big["labels"][:, -1:]], axis=1)
    for row in seq:
        for a, b_ in zip(row[:-1], row[1:]):
            succ.setdefault(int(a), set()).add(int(b_))
    assert max(len(v) for v in succ.values()) <= 8


def test_prefetch_iterator():
    it = PrefetchIterator(SyntheticLM(32, 8).iterator(2), depth=2)
    batches = [next(it) for _ in range(5)]
    assert all(b["tokens"].shape == (2, 8) for b in batches)
    it.close()


# ---- against the JAX package --------------------------------------------------

GRAD_CONFIGS = ["qwen3-1.7b", "mamba2-1.3b", "hymba-1.5b",
                "granite-moe-3b-a800m", "llama-3.2-vision-11b"]


def _inputs(jcfg, seed=0):
    """Seeded tokens, labels (a few -100), frontend for a reduced config."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labs[0, :3] = -100
    fe = (rng.standard_normal((2, jcfg.frontend_tokens, jcfg.fdim))
          .astype(np.float32) if jcfg.frontend_tokens else None)
    return toks, labs, fe


@pytest.fixture(scope="module")
def jax_grads():
    """One ``jax.value_and_grad`` of the JAX loss per config, shared by the
    port's remat and no-remat cases."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = jget_config(name).reduced()
            jp = M.init_params(jax.random.PRNGKey(0), jcfg)
            toks, labs, fe = _inputs(jcfg)
            (loss, aux), g = jax.value_and_grad(
                lambda p: jtrain_loop.loss_fn(
                    p, jcfg, jnp.asarray(toks), jnp.asarray(labs),
                    None if fe is None else jnp.asarray(fe)),
                has_aux=True)(jp)
            cache[name] = (jp, (toks, labs, fe), float(loss),
                           {k: float(v) for k, v in aux.items()},
                           [np.asarray(x) for x in jax.tree.leaves(g)])
        return cache[name]
    return get


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", GRAD_CONFIGS)
def test_loss_and_every_gradient_match_jax(jax_grads, name, remat):
    """atol 1e-5·max(1, max|g|) per leaf: the JAX suite's f32 forward
    tolerance scaled to the leaf's gradient (the backward sums over the
    batch and the sequence in another order than XLA's)."""
    jp, (toks, labs, fe), jloss, jaux, jg = jax_grads(name)
    cfg = get_config(name).reduced()
    params = _bridged(jp)
    batch = {"tokens": toks, "labels": labs}
    if fe is not None:
        batch["frontend"] = fe
    loss, aux, grads = loss_and_grads(params, cfg, batch, remat=remat)
    assert float(loss) == pytest.approx(jloss, abs=1e-5)
    assert float(aux["aux"]) == pytest.approx(jaux["aux"], abs=1e-6)
    if name.startswith("granite"):
        assert jaux["aux"] > 0                 # the MoE aux loss is in it
    assert len(T.leaves(grads)) == len(jg)
    for (path, got), want in zip(T.flatten_with_paths(grads), jg):
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg=path)


def _random_tree(jcfg, seed):
    """Params of a reduced config's shapes, every leaf random (norm gains
    too, so that weight decay shows on them), as numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(np.asarray,
                          M.init_params(jax.random.PRNGKey(0), jcfg))
    return jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes)


@pytest.mark.parametrize("steps", [1, 3])
def test_apply_matches_jax_on_the_same_gradients(steps):
    jcfg = jget_config("qwen3-1.7b").reduced()
    p_np = _random_tree(jcfg, 1)
    grads_np = [_random_tree(jcfg, 10 + i) for i in range(steps)]
    for g in grads_np:      # no gradient: only weight decay moves these
        g["layers"][0]["pre_norm"][...] = 0.0
        g["final_norm"][...] = 0.0
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jopt.init(jp)
    tp = params_from_numpy(p_np, "cpu")
    state = opt.init(tp)
    for g in grads_np:
        jp, jstate, jm = jopt.apply(jocfg, jp, jax.tree.map(jnp.asarray, g),
                                    jstate)
        out, state, m = opt.apply(ocfg, tp, params_from_numpy(g, "cpu"),
                                  state)
        assert out is tp                       # updated in place
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.step) == int(jstate.step) == steps
    for got, want in ((tp, jp), (state.mu, jstate.mu), (state.nu, jstate.nu)):
        for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    # the JAX code's decay rule: the stacked norm gain (ndim 2) decays,
    # final_norm (ndim 1) does not
    pre = tp["layers"][0]["pre_norm"].numpy()
    assert np.abs(pre).max() < np.abs(p_np["layers"][0]["pre_norm"]).max()
    np.testing.assert_array_equal(tp["final_norm"].numpy(),
                                  p_np["final_norm"])


def test_schedule_matches_jax():
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 10, 55, 100):              # start, warmup, mid, end
        assert float(opt.schedule(ocfg, torch.tensor(step))) == \
            pytest.approx(float(jopt.schedule(jocfg, jnp.int32(step))),
                          rel=1e-6)


@pytest.mark.parametrize("task", ["ngram", "copy", "uniform"])
def test_synthetic_batches_equal_jax(task):
    cfg = jget_config("llama-3.2-vision-11b").reduced()
    ours = SyntheticLM(64, 16, task=task, seed=3).iterator(4, cfg)
    theirs = jpipeline.SyntheticLM(64, 16, task=task, seed=3).iterator(4, cfg)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) == ["frontend", "labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_text_corpus_batches_equal_jax():
    text = "pack my box with five dozen liquor jugs. " * 20
    ours = tok.TextCorpus(text, 32, seed=4, vocab_size=100)
    theirs = jtok.TextCorpus(text, 32, seed=4, vocab_size=100)
    for _ in range(3):
        a, b = ours.batch(5), theirs.batch(5)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def _trees(kind):
    """(port tree, JAX tree) of the same values: reduced qwen3's params, or
    an ``AdamWState`` after one step."""
    jcfg = jget_config("qwen3-1.7b").reduced()
    p_np = _random_tree(jcfg, 5)
    if kind == "params":
        return params_from_numpy(p_np, "cpu"), jax.tree.map(jnp.asarray, p_np)
    g_np = _random_tree(jcfg, 6)
    tp = params_from_numpy(p_np, "cpu")
    _, state, _ = opt.apply(opt.AdamWConfig(), tp,
                            params_from_numpy(g_np, "cpu"), opt.init(tp))
    jp = jax.tree.map(jnp.asarray, p_np)
    _, jstate, _ = jopt.apply(jopt.AdamWConfig(), jp,
                              jax.tree.map(jnp.asarray, g_np), jopt.init(jp))
    return state, jstate


@pytest.mark.parametrize("kind", ["params", "opt_state"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_restore_in_the_other_package(tmp_path, writer, kind):
    ours, theirs = _trees(kind)
    keys = [k for k, _ in T.flatten_with_paths(ours)]
    assert keys == [k for k, _ in jckpt._flatten_with_paths(theirs)[0]]
    if kind == "opt_state":
        assert keys[0] == ".step" and keys[1].startswith(".mu/")
    d = str(tmp_path)
    if writer == "port":
        ckpt.save(d, 3, ours)
        back = jckpt.restore(d, theirs)
        got = [np.asarray(x) for x in jax.tree.leaves(back)]
        want = [t.numpy() for t in T.leaves(ours)]
    else:
        jckpt.save(d, 3, theirs)
        template = T.unflatten(ours, [torch.zeros_like(t)
                                      for t in T.leaves(ours)])
        back = ckpt.restore(d, template)
        assert type(back) is type(ours)
        got = [t.numpy() for t in T.leaves(back)]
        want = [np.asarray(x) for x in jax.tree.leaves(theirs)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---- the kernels refuse to be differentiated, as the JAX package's do -----------

@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-1.3b"])
def test_train_step_through_the_kernels_raises_in_both_packages(name):
    """qwen3 reaches flash_attention, mamba2 ssd_scan: neither package can
    differentiate through them (JAX's Pallas calls fail under grad)."""
    jcfg = jget_config(name).reduced()
    jp = M.init_params(jax.random.PRNGKey(0), jcfg)
    batch = jpipeline.SyntheticLM(jcfg.vocab_size, 16, seed=0).batch(2)
    jstep = jtrain_loop.make_train_step(jcfg, jopt.AdamWConfig(),
                                        use_kernel=True, remat=False)
    with pytest.raises(AssertionError):
        jstep(jp, jopt.init(jp),
              {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_config(name).reduced()
    params = _bridged(jp)
    step = make_train_step(cfg, opt.AdamWConfig(), use_kernel=True,
                           remat=False)
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, opt.init(params), batch)
    # the step leaves the tree as it found it: nothing requires grad, and
    # generation through the kernels' entries runs
    assert not any(p.requires_grad for p in T.leaves(params))
    logits, cache = prefill(params, cfg, torch.from_numpy(batch["tokens"]),
                            20, use_kernel=True)
    decode_step(params, cfg, cache, logits.argmax(-1, keepdim=True).int(),
                16, use_kernel=True)


def _wrapper_calls():
    def t(*shape, grad=False):
        g = torch.Generator().manual_seed(len(shape))
        return torch.randn(shape, generator=g).requires_grad_(grad)
    return {
        "flash_attention": lambda g: tfa.flash_attention(
            t(1, 8, 2, 16, grad=g), t(1, 8, 1, 16), t(1, 8, 1, 16)),
        "decode_attention": lambda g: tdec.decode_attention(
            t(1, 1, 2, 16), t(1, 8, 1, 16, grad=g), t(1, 8, 1, 16),
            torch.ones(8, dtype=torch.bool)),
        "ssd_scan": lambda g: tssd.ssd_scan(
            t(1, 8, 2, 4), t(1, 8, 2).abs(), -t(2, grad=g).abs(),
            t(1, 8, 4), t(1, 8, 4), chunk=4),
        "ensemble_combine": lambda g: tcomb.ensemble_combine(
            t(2, 3, 5, grad=g), t(2)),
        "ensemble_combine_quant": lambda g: tcomb.ensemble_combine_quant(
            t(3, 5, grad=g), torch.ones((2, 3, 5), dtype=torch.int8),
            t(2, 3).abs(), t(2)),
    }


@pytest.mark.parametrize("kernel", sorted(_wrapper_calls()))
def test_each_wrapper_refuses_grad_on_the_cpu(kernel):
    call = _wrapper_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel has no "
                                           "backward"):
        call(True)
    with torch.no_grad():
        call(True)                             # nothing is recorded: runs
    call(False)                                # nothing requires grad: runs
