"""One rank's memory on the sharded steps: the training step keeps the logits
sharded on the vocabulary (a vocab-parallel cross-entropy), the chunked
attention's carries stay sharded as the queries are, the prefill record's
argument is the params and tokens alone with the cache among its outputs
(as the JAX step makes it inside), the vocab-parallel cross-entropy equals
the plain one with vocabulary padding and label -100 on 2 x 4 and 1 x 1
``gloo`` meshes, hymba's ``long_500k`` under ``cache_seqshard`` fails in
both packages for the same cause, the sharded SSM mixer keeps its heads
sharded over "model" (no chunk states of all the heads on a rank), and the
chunked attention of heads that divide no mesh dim keeps at most two
chunks of scores live.  Every process group lives in a
subprocess of its own, with its own timeout."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = __file__.rsplit("/tests", 1)[0]
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "OMP_NUM_THREADS": "1"}


def _run(code: str, timeout=240, env=ENV):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=timeout, env=env)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_2x4():
    """Reduced qwen3 (vocab 512) on a fake 2 x 4 mesh: the largest storage
    a train step (B 4, S 256) and a chunked prefill (B 4, S 4096, head_dim
    128) allocate, the prefill's record, and the local bytes of its params,
    tokens and cache."""
    code = """
        import dataclasses, json, sys
        sys.path.insert(0, "src")
        import torch
        torch.set_num_threads(1)
        import repro_torch.configs as C
        from repro_torch.configs import get_config
        from repro_torch.launch import hlo_analysis as H
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.steps import lower_step, param_struct
        from repro_torch.models.attention import _DENSE_MAX
        from repro_torch.models.cache import cache_struct
        from repro_torch.models.transformer import param_shapes
        from repro_torch.parallel import sharding as shd
        from repro_torch.training import tree as T

        largest = [0]

        class Largest(H.Memory):
            def alloc(self, storage):
                super().alloc(storage)
                largest[0] = max(largest[0], storage.nbytes())

        H.Memory = Largest
        C.INPUT_SHAPES["f1_train"] = dict(seq_len=256, global_batch=4,
                                          kind="train")
        C.INPUT_SHAPES["f1_prefill"] = dict(seq_len=2 * _DENSE_MAX,
                                            global_batch=4, kind="prefill")
        fake_process_group(8)
        mesh = make_host_mesh(2, 4)
        cfg = get_config("qwen3-1.7b").reduced()
        out = {"vocab_pad": cfg.padded_vocab, "seq": 2 * _DENSE_MAX}
        lower_step(cfg, "f1_train", mesh)
        out["train_largest"] = largest[0]
        largest[0] = 0
        pcfg = dataclasses.replace(cfg, head_dim=128)
        tr = lower_step(pcfg, "f1_prefill", mesh)
        out["prefill_largest"] = largest[0]
        out["prefill"] = tr.memory_analysis()
        out["head_dim"] = pcfg.hd
        out["heads"] = pcfg.num_heads

        def local_bytes(structs, specs):
            n = 0
            for t, spec in zip(structs, shd.spec_leaves(specs)):
                sl = shd.local_slices(t.shape, mesh,
                                      shd.to_placements(spec, mesh))
                k = t.dtype.itemsize
                for s in sl:
                    k *= s.stop - s.start
                n += k
            return n

        ps = param_struct(pcfg)
        out["params_local"] = local_bytes(T.leaves(ps), shd.param_specs(
            pcfg, param_shapes(pcfg), mesh))
        out["tokens_local"] = local_bytes(
            [torch.empty((4, out["seq"]), dtype=torch.int32, device="meta")],
            shd.batch_spec(mesh, 4, 2))
        out["cache_local"] = local_bytes(
            T.leaves(cache_struct(pcfg, 4, out["seq"], torch.bfloat16)),
            shd.cache_specs(pcfg, mesh, 4, out["seq"]))
        print(json.dumps(out))
    """
    return _run(code)


def test_train_step_allocates_no_full_vocab_logits(fake_2x4):
    """No storage of the sharded train step is as large as one rank's
    (B/2, S, V_pad) f32 logits over the whole vocabulary: each rank's
    cross-entropy works on its own quarter of the vocabulary."""
    whole_vocab = 4 // 2 * 256 * fake_2x4["vocab_pad"] * 4
    assert fake_2x4["train_largest"] < whole_vocab, fake_2x4


def test_prefill_allocates_no_global_attention_carry(fake_2x4):
    """No storage of a prefill long enough for ``chunked_attention`` is as
    large as its global (B, S, H, hd) f32 accumulator: the carries are
    each rank's part."""
    acc = 4 * fake_2x4["seq"] * fake_2x4["heads"] * fake_2x4["head_dim"] * 4
    assert fake_2x4["prefill_largest"] < acc, fake_2x4


def test_prefill_record_argument_is_params_and_tokens(fake_2x4):
    """The prefill step makes its cache inside, as the JAX step does: the
    record's argument is this rank's params and tokens, to the byte, and
    its output holds this rank's cache beside the last-token logits."""
    rec = fake_2x4["prefill"]
    assert rec["argument_size_in_bytes"] == \
        fake_2x4["params_local"] + fake_2x4["tokens_local"]
    logits = rec["output_size_in_bytes"] - fake_2x4["cache_local"]
    assert 0 < logits <= 4 * fake_2x4["vocab_pad"] * 2, rec
    assert rec["alias_size_in_bytes"] == 0


@pytest.fixture(scope="module")
def fake_2x4_ssm():
    """On a fake 2 x 4 mesh: the largest storage of the prefill step of
    reduced mamba2 (16 SSM heads, 1072 ``in_proj`` columns, both over the
    4-way "model" axis; B 4, S 1024: 64 chunks of 16), and the most
    storages at least as large as one rank's chunk of scores (B/2, 5, S,
    512) f32 that are live at once in the prefill step of reduced hymba
    with 5 attention and 5 kv heads (B 4, S 2560: five chunks)."""
    code = """
        import dataclasses, json, sys
        sys.path.insert(0, "src")
        import torch
        torch.set_num_threads(1)
        import repro_torch.configs as C
        from repro_torch.configs import get_config
        from repro_torch.launch import hlo_analysis as H
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.steps import lower_step

        big = {"floor": 0, "live": 0, "most": 0, "largest": 0}

        class Counted(H.Memory):
            def alloc(self, storage):
                super().alloc(storage)
                n = storage.nbytes()
                big["largest"] = max(big["largest"], n)
                if big["floor"] and n >= big["floor"]:
                    big["live"] += 1
                    big["most"] = max(big["most"], big["live"])

            def free(self, key, n, num):
                super().free(key, n, num)
                if big["floor"] and n >= big["floor"]:
                    big["live"] -= 1

        H.Memory = Counted
        C.INPUT_SHAPES["f3_ssm"] = dict(seq_len=1024, global_batch=4,
                                        kind="prefill")
        C.INPUT_SHAPES["f3_attn"] = dict(seq_len=2560, global_batch=4,
                                         kind="prefill")
        fake_process_group(8)
        mesh = make_host_mesh(2, 4)
        cfg = get_config("mamba2-1.3b").reduced()
        lower_step(cfg, "f3_ssm", mesh)
        s = cfg.ssm
        out = {"ssm_largest": big["largest"], "batch": 4, "seq": 1024,
               "heads": cfg.ssm_heads, "p": s.head_dim, "n": s.d_state,
               "chunk": s.chunk}
        hcfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                                   num_heads=5, num_kv_heads=5)
        big.update(floor=4 // 2 * 5 * 2560 * 512 * 4, live=0, most=0)
        lower_step(hcfg, "f3_attn", mesh)
        out.update(scores_bytes=big["floor"], scores_live=big["most"])
        print(json.dumps(out))
    """
    return _run(code)


def test_sharded_ssm_prefill_keeps_the_heads_sharded(fake_2x4_ssm):
    """No storage of reduced mamba2's sharded prefill is as large as one
    rank's (B/2, nc, H, P, N) f32 chunk states with all H heads: the
    projection, the conv, the scan and the final state run on the rank's
    H/4 heads (``models/ssm.py::_project_parts``)."""
    r = fake_2x4_ssm
    states = r["batch"] // 2 * (r["seq"] // r["chunk"]) * r["heads"] * \
        r["p"] * r["n"] * 4
    assert r["ssm_largest"] < states, r


def test_chunked_attention_keeps_two_chunks_of_scores(fake_2x4_ssm):
    """With heads that divide no mesh dim (head_dim sharded, so each rank's
    reduced scores hold all the heads), at most two storages of one rank's
    (B/2, H, S, 512) f32 chunk scores are live at once in the sharded
    prefill: the einsum's part and its reduced sum, which then takes the
    bias, the shift and the exp in place (``attention.chunked_attention``).
    Out of place, the bias, the shift, the exp and the last chunk's
    probabilities made four."""
    r = fake_2x4_ssm
    assert 1 <= r["scores_live"] <= 2, r


_CE_RANK = """
import json, os, sys
sys.path.insert(0, "src")
import numpy as np, torch
torch.set_num_threads(1)
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import join_process_group, make_host_mesh
from repro_torch.parallel.collectives import vocab_parallel_nll

join_process_group(cpu=True)
d, m = int(sys.argv[1]), int(sys.argv[2])
mesh = make_host_mesh(d, m)
B, S, V, vocab = 4, 6, 512, 490          # 22 pad columns, all in the last
rng = np.random.default_rng(0)           # of the "model" shards
x = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
labels = rng.integers(0, vocab, (B, S))
labels[0, :2] = -100
labels[1, 0] = vocab - 1                 # a label in the last shard
labels[2, 0] = 0
mask = torch.tensor(labels >= 0, dtype=torch.float32)
safe = torch.tensor(np.maximum(labels, 0))

# the plain path of training.train_loop.loss_fn
ref = torch.tensor(x, requires_grad=True)
bias = torch.cat([torch.zeros(vocab), torch.full((V - vocab,), -1e30)])
logp = torch.log_softmax(ref + bias, dim=-1)
nll_ref = -torch.gather(logp, -1, safe[..., None])[..., 0]
((nll_ref * mask).sum() / mask.sum()).backward()

xd = distribute_tensor(torch.tensor(x), mesh, [Shard(0), Shard(2)])
xd.requires_grad_(True)
lab = distribute_tensor(safe, mesh, [Shard(0), Replicate()])
md = distribute_tensor(mask, mesh, [Shard(0), Replicate()])
nll = vocab_parallel_nll(xd, lab, vocab)
ce = (nll * md).sum() / md.sum()
ce.backward()
out = {"placements": [p.dim if p.is_shard() else str(p)
                      for p in nll.placements],
       "nll": float((nll.full_tensor() - nll_ref).abs().max()),
       "grad": float((xd.grad.full_tensor() - ref.grad).abs().max()),
       "pad_grad": float(xd.grad.full_tensor()[..., vocab:].abs().max()),
       "grad_top": float(ref.grad.abs().max())}
if int(os.environ["RANK"]) == 0:
    print(json.dumps(out))
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("d,m", [(2, 4), (1, 1)])
def test_vocab_parallel_ce_matches_plain(d, m):
    """``vocab_parallel_nll`` on logits sharded (batch over "data", vocab
    over "model") against the plain path's log_softmax on the same numpy
    logits: padding columns masked in the last shard, label -100 masked,
    each nll within 1e-5 and every gradient element within 1e-6; the pad
    columns get
    no gradient."""
    port = _free_port()
    n = d * m
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CE_RANK, str(d), str(m)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**ENV, "RANK": str(r), "WORLD_SIZE": str(n),
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert got["placements"][0] == 0 and got["placements"][1] == "R", got
    assert got["nll"] <= 1e-5, got
    assert got["grad"] <= 1e-6 * max(1.0, got["grad_top"]), got
    assert got["pad_grad"] == 0.0, got


def test_hymba_long_500k_cache_seqshard_fails_in_both_packages():
    """A reference behaviour copied on purpose: hymba's ``long_500k``
    decode under ``cache_seqshard`` fails in both dry-runs, for one cause:
    at batch 1 the batch fits no 16-way "data" axis.  JAX's
    ``flash_decode`` ``shard_map`` refuses its in_specs; the port's
    ``cache_specs`` put the cache's L over ("data", "model") and the batch
    on no axis, which the port's ``flash_decode`` refuses."""
    jax_rec = _run("""
        import json, sys
        sys.path.insert(0, "src")
        from repro.launch.dryrun import run_one
        rec = run_one("hymba-1.5b", "long_500k", variant="cache_seqshard",
                      save=False, verbose=False)
        print(json.dumps({"ok": rec["ok"], "error": rec.get("error", "")}))
    """, env={**ENV, "JAX_PLATFORMS": "cpu"})
    port_rec = _run("""
        import json, sys
        sys.path.insert(0, "src")
        from repro_torch import runtime_flags
        from repro_torch.configs import INPUT_SHAPES, get_config
        from repro_torch.launch.dryrun import run_one
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.parallel import sharding as shd
        rec = run_one("hymba-1.5b", "long_500k", variant="cache_seqshard",
                      save=False, verbose=False)
        mesh = make_production_mesh()
        runtime_flags.set_variant("cache_seqshard", mesh)
        sh = INPUT_SHAPES["long_500k"]
        spec = shd.cache_specs(get_config("hymba-1.5b"), mesh,
                               sh["global_batch"], sh["seq_len"])
        k = next(e["k"] for e in spec["layers"] if "k" in e)
        print(json.dumps({"ok": rec["ok"], "error": rec.get("error", ""),
                          "batch": sh["global_batch"],
                          "k_spec": [list(a) if isinstance(a, tuple) else a
                                     for a in k]}))
    """)
    assert not jax_rec["ok"] and not port_rec["ok"]
    assert "of size 1) to mesh axis 'data' (of size 16)" in jax_rec["error"]
    assert "flash_decode: the cache must be a DTensor placed" in \
        port_rec["error"], port_rec
    assert port_rec["batch"] == 1
    assert port_rec["k_spec"][1] is None                  # the batch axis
    assert port_rec["k_spec"][2] == ["data", "model"]     # L over both
