"""The port's parallel tooling against the JAX package's, on the same numpy
inputs:

* ``flash_decode`` on 8 ``gloo`` ranks as a 2 x 4 ("data", "model") mesh
  (one spawned process each) against JAX's ``flash_decode`` on an 8-device
  host mesh (a subprocess with ``XLA_FLAGS``), at the four ``(window, pos)``
  cases of tests/test_flash_decode_shardmap.py: out within 1e-5, caches
  within 1e-6;
* reduced qwen3 and gemma3 ``decode_step`` under ``cache_seqshard`` on that
  mesh (params placed per ``param_specs``, the cache per ``cache_specs``)
  within 1e-5 of JAX's plain ``decode_step`` with the same params;
* the ``"dots"`` remat policy: loss and gradients within 1e-6 (of each
  leaf's max) of full remat, and within 1e-5 of each leaf's max of JAX's
  ``loss_fn`` under ``attn_repl+remat_dots`` (the two frameworks' f32
  sums differ by up to 1.4e-6 of a leaf's max on these inputs), with
  fewer products run than under full remat;
* the training step on that mesh (params placed per ``param_specs``, the
  batch by ``shard_batch``): reduced qwen3 (baseline and ``fsdp``) and
  granite (dense MoE, and the capacity MoE under ``moe_ep``), reduced
  mamba2 and hymba (their 16 SSM heads and 1072-column ``in_proj``
  sharded over "model") and hymba with 5 attention heads, which divide no
  mesh dim: the loss and every gradient leaf within 1e-5·max(1, max|g|)
  of ``jax.value_and_grad``, and 3 AdamW steps' losses within 1e-5 of
  the plain ``train_step``'s;
* the sharded prefill step (``launch.steps.build_prefill_step``) on that
  mesh for reduced mamba2, hymba and 5-head hymba, a prompt longer than
  ``_DENSE_MAX`` (the chunked attention and many SSM chunks): the
  last-token logits and every cache tensor within 1e-5 of JAX's
  ``prefill``."""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as M  # noqa: E402
from repro import runtime_flags as jflags  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.training.train_loop import loss_fn as jloss_fn  # noqa: E402
from repro_torch import runtime_flags as flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from repro_torch.training.train_loop import loss_fn  # noqa: E402

ROOT = __file__.rsplit("/tests", 1)[0]
CASES = [(0, 20), (0, 31), (16, 20), (16, 37 % 32 + 16)]
B, L, H, KV, HD = 4, 32, 4, 2, 16
ARCHS = ("qwen3-1.7b", "gemma3-1b")
PROMPT, MAX_LEN, STEPS = 70, 96, 4    # the SWA rings (64 slots) have wrapped


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flash_inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(q=f(B, 1, H, HD), kc=f(B, L, KV, HD), vc=f(B, L, KV, HD),
                kn=f(B, 1, KV, HD), vn=f(B, 1, KV, HD))


_JAX_FLASH = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.parallel.collectives import flash_decode
d = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for i, (window, pos) in enumerate(%r):
    with mesh:
        o, kc, vc = flash_decode(mesh, *(jnp.asarray(d[k]) for k in
                                         ("q", "kc", "vc", "kn", "vn")),
                                 jnp.int32(pos), window=window)
    out[f"out{i}"], out[f"kc{i}"], out[f"vc{i}"] = map(np.asarray, (o, kc, vc))
np.savez(sys.argv[2], **out)
"""

_RANK = """
import os, sys
sys.path.insert(0, "src")
import numpy as np, torch
torch.set_num_threads(1)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import runtime_flags
from repro_torch.configs import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import join_process_group, make_host_mesh
from repro_torch.models import decode_step, init_params
from repro_torch.models.transformer import param_shapes
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.collectives import flash_decode
from repro_torch.training import tree as T

join_process_group(cpu=True)
mesh = make_host_mesh(2, 4)
runtime_flags.set_variant("cache_seqshard", mesh)
d = dict(np.load(sys.argv[1]))
res = {}

def place(a, spec):
    return shd.place([torch.from_numpy(np.ascontiguousarray(a))], [spec],
                     mesh)[0]

def place_tree(like, specs, prefix):
    paths = [p for p, _ in T.flatten_with_paths(like)]
    return shd.place(T.unflatten(like, [torch.from_numpy(d[prefix + p])
                                        for p in paths]), specs, mesh)

with implicit_replication():
    for i, (window, pos) in enumerate(%r):
        cache = shd.P("data", "model", None, None)
        rep = shd.P("data", None, None, None)
        kc, vc = place(d["kc"], cache), place(d["vc"], cache)
        out = flash_decode(mesh, place(d["q"], rep), kc, vc,
                           place(d["kn"], rep), place(d["vn"], rep), pos,
                           window=window)
        res[f"out{i}"] = out.full_tensor().numpy()
        res[f"kc{i}"] = kc.full_tensor().numpy()
        res[f"vc{i}"] = vc.full_tensor().numpy()
    for arch in %r:
        cfg = get_config(arch).reduced()
        like = init_params(cfg, 0, "cpu")
        params = place_tree(like, shd.param_specs(cfg, param_shapes(cfg), mesh),
                            arch + ":p:")
        b = d[arch + ":tokens"].shape[0]
        ctree = {"layers": [{n: None for n in e} for e in
                            shd.cache_specs(cfg, mesh, b, %d)["layers"]]}
        cache = place_tree(ctree, shd.cache_specs(cfg, mesh, b, %d),
                           arch + ":c:")
        toks = d[arch + ":tokens"]
        for s in range(%d):
            tok = shard_batch({"t": toks[:, s:s + 1]}, mesh)["t"]
            logits, cache = decode_step(params, cfg, cache, tok, %d + s)
            res[f"{arch}:logits{s}"] = logits.full_tensor().numpy()
if int(os.environ["RANK"]) == 0:
    np.savez(sys.argv[2], **res)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _jax_decode_reference(arch):
    """(params, the cache after the prompt, tokens, the logits of each
    decode step) from the JAX package's plain path."""
    cfg = jget_config(arch).reduced()
    params = M.init_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (4, PROMPT + STEPS)).astype(np.int32)
    _, cache = M.prefill(params, cfg, jnp.asarray(toks[:, :PROMPT]), MAX_LEN)
    prompt_cache = jax.tree.map(np.asarray, cache)
    logits = []
    for s in range(STEPS):
        lg, cache = M.decode_step(params, cfg, cache,
                                  jnp.asarray(toks[:, PROMPT + s:PROMPT + s + 1]),
                                  jnp.int32(PROMPT + s))
        logits.append(np.asarray(lg))
    return jax.tree.map(np.asarray, params), prompt_cache, toks, logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    feed = dict(_flash_inputs())
    refs = {}
    for arch in ARCHS:
        params, cache, toks, logits = _jax_decode_reference(arch)
        refs[arch] = logits
        for p, a in T.flatten_with_paths(params):
            feed[f"{arch}:p:{p}"] = a
        for p, a in T.flatten_with_paths(cache):
            feed[f"{arch}:c:{p}"] = a
        feed[f"{arch}:tokens"] = toks[:, PROMPT:]
    np.savez(tmp / "in.npz", **feed)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_FLASH % (CASES,), str(tmp / "in.npz"),
         str(tmp / "jax.npz")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port = _free_port()
    code = _RANK % (CASES, ARCHS, MAX_LEN, MAX_LEN, STEPS, PROMPT)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / "in.npz"),
         str(tmp / "torch.npz")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**env, "RANK": str(r), "WORLD_SIZE": "8",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
        for r in range(8)]
    try:
        outs = [p.communicate(timeout=240) for p in ranks + [jax_run]]
    finally:
        for p in ranks + [jax_run]:
            p.kill()
    for p, (_, err) in zip(ranks + [jax_run], outs):
        assert p.returncode == 0, err[-3000:]
    return (dict(np.load(tmp / "torch.npz")), dict(np.load(tmp / "jax.npz")),
            refs)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"w{w}-pos{p}" for w, p in CASES])
def test_flash_decode_matches_jax_on_8_gloo_ranks(runs, i):
    got, want, _ = runs
    assert float(np.abs(got[f"out{i}"] - want[f"out{i}"]).max()) < 1e-5
    np.testing.assert_allclose(got[f"kc{i}"], want[f"kc{i}"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got[f"vc{i}"], want[f"vc{i}"], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_cache_seqshard_matches_jax_plain(runs, arch):
    got, _, refs = runs
    for s in range(STEPS):
        err = float(np.abs(got[f"{arch}:logits{s}"] - refs[arch][s]).max())
        assert err < 1e-5, (arch, s, err)


# ---- the "dots" remat policy ------------------------------------------------

class _CountProducts(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func._overloadpacket) in ("aten.mm", "aten.bmm", "aten.addmm",
                                         "aten.baddbmm"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _port_loss_grads(cfg, params, tokens, labels, variant):
    flags.set_variant(variant)
    try:
        leaves = T.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with _CountProducts() as count:
            loss, _ = loss_fn(params, cfg, tokens, labels, remat=True)
            grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
    finally:
        flags.set_variant("baseline")
    return float(loss.detach()), [g.numpy() for g in grads], count.n


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_dots_remat_policy(arch):
    torch.set_num_threads(1)
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jparams = M.init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    full_loss, full_g, full_n = _port_loss_grads(cfg, params, tt, tl,
                                                 "baseline")
    dots_loss, dots_g, dots_n = _port_loss_grads(cfg, params, tt, tl,
                                                 "attn_repl+remat_dots")
    jflags.set_variant("attn_repl+remat_dots")
    try:
        (jl, _), jg = jax.value_and_grad(
            lambda p: jloss_fn(p, jcfg, jnp.asarray(tokens),
                               jnp.asarray(labels), remat=True),
            has_aux=True)(jparams)
    finally:
        jflags.set_variant("baseline")
    jg = [np.asarray(g) for _, g in T.flatten_with_paths(
        jax.tree.map(np.asarray, jg))]
    assert dots_loss == pytest.approx(full_loss, abs=1e-6)
    assert dots_loss == pytest.approx(float(jl), abs=1e-6)
    for d, f, j in zip(dots_g, full_g, jg):
        top = max(float(np.abs(j).max()), 1e-30)
        np.testing.assert_allclose(d, f, rtol=0, atol=1e-6 * top)
        np.testing.assert_allclose(d, j, rtol=0, atol=1e-5 * top)
    assert dots_n < full_n, (dots_n, full_n)


# ---- the pod path's gradients and the sharded prefill on the 2 x 4 mesh -----

# (config, variant): the "model" axis of 4 shards the heads (qwen3's wq),
# head_dim (its wk and wv: 2 kv heads), the vocabulary, the experts and the
# SSM heads (mamba2's and hymba's 16, with their 1072 in_proj columns);
# "fsdp" adds "data" to the params, so the gradients reduce-scatter onto them
POD_CASES = [("qwen3-1.7b", "baseline"), ("qwen3-1.7b", "fsdp"),
             ("granite-moe-3b-a800m", "baseline"),
             ("granite-moe-3b-a800m:capacity", "moe_ep"),
             ("mamba2-1.3b", "baseline"), ("hymba-1.5b", "baseline"),
             ("hymba-1.5b:heads5", "baseline")]
POD_STEPS = 3
# the prefill's prompt is longer than attention._DENSE_MAX (2048): the
# chunked attention runs, with a padded last KV chunk, and the SSM scans 131
# chunks of 16
PREFILL_CASES = ["mamba2-1.3b", "hymba-1.5b", "hymba-1.5b:heads5"]
PREFILL_B, PREFILL_S = 2, 2096
# collectives.pad's placements ("data", "model"): a tensor dim, -1 for
# none; dim 1, the padded one, moves to dim 2 where it is sharded
PAD_CASES = [(0, 1), (0, 2), (-1, 1), (1, -1), (-1, -1)]

# A case's config: the reduced config of "arch", changed by its suffix:
# ":capacity" the MoE's dispatch, ":heads5" 5 attention and 5 kv heads
# (hymba), which divide neither mesh dim, so head_dim is sharded.  The
# rank script runs the same source with the port's ``get_config``.
_CONFIG_SRC = """
def config(name, get=get_config):
    arch, _, change = name.partition(":")
    cfg = get(arch).reduced()
    if change == "heads5":
        return dataclasses.replace(cfg, num_heads=5, num_kv_heads=5)
    if change:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=change))
    return cfg
"""

_POD_RANK = """
import os, sys
sys.path.insert(0, "src")
import dataclasses
import numpy as np, torch
torch.set_num_threads(1)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import runtime_flags
from repro_torch.configs import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import join_process_group, make_host_mesh
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import init_params
from repro_torch.models.transformer import param_shapes
from repro_torch.parallel import sharding as shd
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as T
from repro_torch.training.train_loop import loss_and_grads, make_train_step

join_process_group(cpu=True)
mesh = make_host_mesh(2, 4)
d = dict(np.load(sys.argv[1]))
res = {}
%s

def placed(name, cfg, key):   # a copy: a replicated leaf is the tensor given
    like = init_params(cfg, 0, "cpu")
    return shd.place(T.unflatten(like, [
        torch.tensor(d[f"{name}:{key}:{p}"])
        for p, _ in T.flatten_with_paths(like)]),
        shd.param_specs(cfg, param_shapes(cfg), mesh), mesh)

with implicit_replication():
    for i, (name, variant) in enumerate(%r):
        runtime_flags.set_variant(variant, mesh)
        cfg = config(name)
        batch = shard_batch({"tokens": d[f"{name}:tokens0"],
                             "labels": d[f"{name}:labels0"]}, mesh)
        loss, _, grads = loss_and_grads(placed(name, cfg, "p"), cfg, batch,
                                        remat=True)
        res[f"{i}:loss"] = loss.full_tensor().numpy()
        for p, g in T.flatten_with_paths(grads):
            res[f"{i}:g:{p}"] = g.full_tensor().numpy()
        params = placed(name, cfg, "p")
        state = opt.init(params)
        step = make_train_step(cfg, opt.AdamWConfig(total_steps=%d),
                               remat=True)
        for s in range(%d):
            batch = shard_batch({"tokens": d[f"{name}:tokens{s}"],
                                 "labels": d[f"{name}:labels{s}"]}, mesh)
            params, state, m = step(params, state, batch)
            res[f"{i}:step{s}"] = m["loss"].full_tensor().numpy()
    runtime_flags.set_variant("baseline")
    for name in %r:
        cfg = config(name)
        tokens = shard_batch({"t": d[f"{name}:prompt"]}, mesh)["t"]
        logits, cache = build_prefill_step(cfg, %d, mesh)(
            placed(name, cfg, "pp"), tokens)
        res[f"{name}:logits"] = logits.full_tensor().numpy()
        for p, t in T.flatten_with_paths(cache):
            res[f"{name}:c:{p}"] = t.full_tensor().numpy()
    # collectives.pad on each placement of a (4, 16, 8) tensor, padding dim
    # 1, and the gradient of the sum of its squares
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.parallel.collectives import pad
    for i, pl in enumerate(%r):
        t = distribute_tensor(torch.tensor(d["pad:x"]), mesh,
                              [Shard(p) if p >= 0 else Replicate()
                               for p in pl]).requires_grad_(True)
        out = pad(t, (0, 0, 3, 1), value=0.5)
        (out * out).sum().backward()
        res[f"pad{i}"] = out.full_tensor().detach().numpy()
        res[f"pad{i}:grad"] = t.grad.full_tensor().numpy()
if int(os.environ["RANK"]) == 0:
    np.savez(sys.argv[2], **res)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _pod_config(name, get):
    scope = {"dataclasses": dataclasses, "get_config": get}
    exec(_CONFIG_SRC, scope)
    return scope["config"](name)


def _pod_batches(vocab, seed):
    """POD_STEPS seeded (tokens, labels) of (2, 16), a few labels -100."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(POD_STEPS):
        toks = rng.integers(0, vocab, (2, 16)).astype(np.int32)
        labs = rng.integers(0, vocab, (2, 16)).astype(np.int32)
        labs[0, :3] = -100
        out.append((toks, labs))
    return out


def _feed_params(feed, prefix, jp):
    for p, a in T.flatten_with_paths(jax.tree.map(np.asarray, jp)):
        feed[f"{prefix}:{p}"] = a


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    """The 8 ranks' results: per POD case the loss, gradients and POD_STEPS
    train-step losses, per PREFILL case the gathered logits and cache.
    While the ranks run, the references: per POD case JAX's loss and
    gradients on the first batch and the port's plain train steps on the
    same params and batches, per PREFILL case JAX's ``prefill`` of the same
    params and prompt, run op by op (``jax.disable_jit``): under ``jit``
    XLA fuses RoPE's sin and cos into an approximation that differs from
    its own unfused ones by 3.4e-5 at positions near 2000 (hymba's ``k``),
    where the port's RoPE matches the unfused ones within 1e-6."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    tmp = tmp_path_factory.mktemp("pod")
    feed, cases, prompts = {}, [], {}
    for name, _ in POD_CASES:
        jcfg = _pod_config(name, jget_config)
        jp = M.init_params(jax.random.PRNGKey(5), jcfg)
        batches = _pod_batches(jcfg.vocab_size, 6)
        _feed_params(feed, f"{name}:p", jp)
        for s, (toks, labs) in enumerate(batches):
            feed[f"{name}:tokens{s}"], feed[f"{name}:labels{s}"] = toks, labs
        cases.append((name, jcfg, jp, batches))
    for name in PREFILL_CASES:
        jcfg = _pod_config(name, jget_config)
        jp = M.init_params(jax.random.PRNGKey(7), jcfg)
        toks = np.random.default_rng(8).integers(
            0, jcfg.vocab_size, (PREFILL_B, PREFILL_S)).astype(np.int32)
        _feed_params(feed, f"{name}:pp", jp)
        feed[f"{name}:prompt"] = toks
        prompts[name] = (jcfg, jp, jnp.asarray(toks))
    feed["pad:x"] = np.random.default_rng(9).standard_normal(
        (4, 16, 8)).astype(np.float32)
    np.savez(tmp / "in.npz", **feed)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    port = _free_port()
    code = _POD_RANK % (_CONFIG_SRC, POD_CASES, POD_STEPS, POD_STEPS,
                        PREFILL_CASES, PREFILL_S, PAD_CASES)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / "in.npz"),
         str(tmp / "torch.npz")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**env, "RANK": str(r), "WORLD_SIZE": "8",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
        for r in range(8)]
    try:
        want, want_prefill = [], {}
        for name, jcfg, jp, batches in cases:
            (jl, _), jg = jax.value_and_grad(
                lambda p: jloss_fn(p, jcfg, jnp.asarray(batches[0][0]),
                                   jnp.asarray(batches[0][1])),
                has_aux=True)(jp)
            cfg = _pod_config(name, get_config)
            params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
            state = opt.init(params)
            step = make_train_step(cfg, opt.AdamWConfig(total_steps=POD_STEPS),
                                   remat=True)
            plain = []
            for toks, labs in batches:
                params, state, m = step(params, state,
                                        {"tokens": toks, "labels": labs})
                plain.append(float(m["loss"]))
            want.append((float(jl), T.flatten_with_paths(
                jax.tree.map(np.asarray, jg)), plain))
        with jax.disable_jit():
            for name, (jcfg, jp, toks) in prompts.items():
                lg, cache = M.prefill(jp, jcfg, toks, PREFILL_S)
                want_prefill[name] = (np.asarray(lg), T.flatten_with_paths(
                    jax.tree.map(np.asarray, cache)))
        outs = [p.communicate(timeout=300) for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, (_, err) in zip(ranks, outs):
        assert p.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "torch.npz")), want, want_prefill, feed["pad:x"]


@pytest.mark.parametrize("i", range(len(POD_CASES)),
                         ids=[f"{n}-{v}" for n, v in POD_CASES])
def test_pod_loss_and_every_gradient_match_jax_on_2x4(pod_runs, i):
    """The loss and every gradient leaf of reduced configs with params
    placed per ``param_specs`` on 8 gloo ranks (2 x 4), gathered, against
    ``jax.value_and_grad`` on the same numpy params and batch: atol
    1e-5·max(1, max|g|) per leaf, as tests/test_torch_training.py."""
    got, want, _, _ = pod_runs
    jloss, jg, _ = want[i]
    assert float(got[f"{i}:loss"]) == pytest.approx(jloss, abs=1e-5)
    assert sorted(k for k in got if k.startswith(f"{i}:g:")) == sorted(
        f"{i}:g:{p}" for p, _ in jg)
    for path, w in jg:
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[f"{i}:g:{path}"], w, rtol=0, atol=tol,
                                   err_msg=path)


@pytest.mark.parametrize("i", range(len(POD_CASES)),
                         ids=[f"{n}-{v}" for n, v in POD_CASES])
def test_pod_train_steps_match_plain_steps_on_2x4(pod_runs, i):
    """POD_STEPS AdamW steps on the sharded params (DTensor updates of the
    sharded optimizer state) give the plain train_step's losses within
    1e-5."""
    got, want, _, _ = pod_runs
    plain = want[i][2]
    for s in range(POD_STEPS):
        assert abs(float(got[f"{i}:step{s}"]) - plain[s]) < 1e-5, (
            s, [float(got[f"{i}:step{t}"]) for t in range(POD_STEPS)],
            plain)


@pytest.mark.parametrize("name", PREFILL_CASES)
def test_sharded_prefill_matches_jax_on_2x4(pod_runs, name):
    """The prefill step (``launch.steps.build_prefill_step``) of a reduced
    config with params placed per ``param_specs`` and the cache per
    ``cache_specs`` on 8 gloo ranks (2 x 4), a prompt of PREFILL_S tokens:
    the last-token logits and every cache tensor (``h``, ``conv``, ``k``,
    ``v``), gathered, within 1e-5 of JAX's ``prefill`` (op by op) on the
    same numpy params and prompt.  ":heads5" is reduced hymba with
    ``num_heads=5, num_kv_heads=5`` (``_CONFIG_SRC``)."""
    got, _, want, _ = pod_runs
    logits, cache = want[name]
    np.testing.assert_allclose(got[f"{name}:logits"], logits, rtol=0,
                               atol=1e-5)
    assert sorted(k for k in got if k.startswith(f"{name}:c:")) == sorted(
        f"{name}:c:{p}" for p, _ in cache)
    for path, w in cache:
        np.testing.assert_allclose(got[f"{name}:c:{path}"], w, rtol=0,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("i", range(len(PAD_CASES)),
                         ids=[f"data{d}-model{m}" for d, m in PAD_CASES])
def test_pad_matches_f_pad_on_2x4(pod_runs, i):
    """``parallel.collectives.pad`` of a DTensor placed per PAD_CASES on 8
    gloo ranks (2 x 4), dim 1 padded (3, 1) with 0.5: the gathered result
    equals ``F.pad`` of the whole tensor, and the gradient of the sum of
    its squares is 2x, exactly."""
    got, _, _, x = pod_runs
    want = np.pad(x, ((0, 0), (3, 1), (0, 0)), constant_values=0.5)
    np.testing.assert_array_equal(got[f"pad{i}"], want)
    np.testing.assert_array_equal(got[f"pad{i}:grad"], 2 * x)
