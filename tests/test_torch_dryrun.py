"""The port's dry-run tooling: every reduced architecture's train and decode
steps traced sharded on a fake 2 x 4 mesh (registered as
tests/test_dryrun_small.py registers them), their per-rank memory analysis
held to the same steps on real tensors, byte for byte, and to hand counts,
the production mesh shapes, the trace analysis (a collective inside a
7-layer loop counts 7 times), the roofline's three terms by hand, the
training launcher's pod path on 2 ``gloo`` ranks against 1 rank, and
``--dry-run``.  Every fake or gloo group lives in a subprocess of its own,
with its own timeout."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import list_architectures  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

ROOT = __file__.rsplit("/tests", 1)[0]
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "OMP_NUM_THREADS": "1"}


def _run(code: str, timeout=240):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=timeout, env=ENV)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out.stdout


@pytest.fixture(scope="module")
def small_mesh_traces():
    """{arch: {shape: (flops per rank, collective bytes, ops, argument
    bytes, memory analysis of the fake trace, the same of the step on real
    tensors)}} from one subprocess on a fake 8-rank group."""
    code = f"""
        import json, sys
        sys.path.insert(0, "src")
        import torch
        torch.set_num_threads(1)
        import repro_torch.configs as C
        from repro_torch.configs import get_config
        from repro_torch.launch import hlo_analysis as H
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.steps import lower_step
        C.INPUT_SHAPES["tiny_train"] = dict(seq_len=64, global_batch=4,
                                            kind="train")
        C.INPUT_SHAPES["tiny_decode"] = dict(seq_len=64, global_batch=4,
                                             kind="decode")
        C.INPUT_SHAPES["tiny_prefill"] = dict(seq_len=64, global_batch=4,
                                              kind="prefill")
        fake_process_group(8)
        mesh = make_host_mesh(2, 4)
        out = {{}}
        for arch in {list_architectures()!r}:
            cfg = get_config(arch).reduced()
            out[arch] = {{}}
            for shape in ("tiny_train", "tiny_decode", "tiny_prefill"):
                tr = lower_step(cfg, shape, mesh)
                real = lower_step(cfg, shape, mesh, fake=False)
                out[arch][shape] = [H.flops(tr.trace),
                                    H.collective_bytes(tr.trace)["total_bytes"],
                                    len(tr.trace), tr.argument_bytes,
                                    tr.memory_analysis(),
                                    real.memory_analysis()]
        print(json.dumps(out))
    """
    return json.loads(_run(code, timeout=400).strip().splitlines()[-1])


@pytest.mark.parametrize("arch", list_architectures())
def test_small_mesh_trace(small_mesh_traces, arch):
    for shape in ("tiny_train", "tiny_decode"):
        flops, coll, ops, args = small_mesh_traces[arch][shape][:4]
        assert flops > 0, (arch, shape)
        assert ops > 0 and args > 0, (arch, shape)
    # the train step reduces its gradients over the mesh
    assert small_mesh_traces[arch]["tiny_train"][1] > 0


@pytest.mark.parametrize("arch", list_architectures())
def test_fake_trace_memory_equals_real_tensors(small_mesh_traces, arch):
    """One rank's argument, output, temp and alias bytes under
    ``FakeTensorMode`` are those of the same step run on real CPU tensors,
    to the byte, for the train, prefill and decode steps."""
    for shape, got in small_mesh_traces[arch].items():
        fake, real = got[4], got[5]
        assert fake == real, (arch, shape, fake, real)
        assert set(fake) == {"argument_size_in_bytes", "output_size_in_bytes",
                             "temp_size_in_bytes", "alias_size_in_bytes"}
        assert fake["argument_size_in_bytes"] == got[3]
        assert fake["temp_size_in_bytes"] > 0, (arch, shape)
    # the AdamW update runs in place: params and both moments are outputs
    # in their argument's storage; the batch and the step counter are not
    train = small_mesh_traces[arch]["tiny_train"][4]
    assert 0 < train["alias_size_in_bytes"] < train["argument_size_in_bytes"]
    assert train["alias_size_in_bytes"] < train["output_size_in_bytes"]


def test_memory_of_a_hand_counted_mlp_step():
    """A two-layer MLP's SGD step written out op by op, f32, B 4, D 8, H 16,
    C 2: each allocation is one new storage, views and in-place updates
    allocate nothing, and a storage stops counting when its last tensor
    dies."""
    B, D, Hd, C = 4, 8, 16, 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, D, generator=g)
    w1 = torch.randn(D, Hd, generator=g)
    w2 = torch.randn(Hd, C, generator=g)

    def step(x, w1, w2):
        h = x @ w1                                 # B*H
        a = h.relu()                               # B*H
        y = a @ w2                                 # B*C
        gy = y * (2.0 / (B * C))                   # B*C
        gw2 = a.t() @ gy                           # H*C (a.t() is a view)
        ga = gy @ w2.t()                           # B*H
        gh = torch.ops.aten.threshold_backward(ga, h, 0.0)  # B*H
        gw1 = x.t() @ gh                           # D*H
        w1.sub_(gw1, alpha=0.1)                    # in place: nothing
        w2.sub_(gw2, alpha=0.1)
        return y.square().mean()                   # B*C, then 1, B*C freed

    f32 = 4
    loss, trace, mem = H.record_with_memory(step, x, w1, w2)
    peak = f32 * (4 * B * Hd + 3 * B * C + Hd * C + D * Hd + 1)
    assert mem.peak == peak == 1764
    assert mem.live == f32                         # the loss alone is left
    assert [t.op for t in trace if t.op == "aten.sub_"] == ["aten.sub_"] * 2
    del loss
    assert mem.live == 0


def test_per_rank_argument_bytes_on_a_2x4_mesh():
    """On a fake 2 x 4 mesh with the "fsdp" variant, the embedding is
    sharded over both axes: one rank's argument bytes hold 1/8 of it.  The
    whole record's argument bytes are each leaf's rank-0 slice, and its
    temp bytes are one rank's, under those of the same step on 1 x 1."""
    code = """
        import json, sys
        sys.path.insert(0, "src")
        import torch
        torch.set_num_threads(1)
        import repro_torch.configs as C
        from repro_torch import runtime_flags
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.steps import lower_step, param_struct
        from repro_torch.models.transformer import param_shapes
        from repro_torch.parallel import sharding as shd
        from repro_torch.training import tree as T
        C.INPUT_SHAPES["tiny_train"] = dict(seq_len=64, global_batch=4,
                                            kind="train")
        import torch.distributed as dist
        cfg = get_config("qwen3-1.7b").reduced()
        out = {}
        for name, (d, m) in (("8", (2, 4)), ("1", (1, 1))):
            if dist.is_initialized():
                dist.destroy_process_group()
            fake_process_group(d * m)
            mesh = make_host_mesh(d, m)
            runtime_flags.set_variant("fsdp", mesh)
            specs = shd.spec_leaves(shd.param_specs(cfg, param_shapes(cfg),
                                                    mesh))
            numel = []
            for shape, spec in zip([t.shape for t in
                                    T.leaves(param_struct(cfg))], specs):
                sl = shd.local_slices(shape, mesh,
                                      shd.to_placements(spec, mesh))
                n = 1
                for s in sl:
                    n *= s.stop - s.start
                numel.append(n)
            tr = lower_step(cfg, "tiny_train", mesh)
            out[name] = dict(tr.memory_analysis(), local_numel=sum(numel),
                             embed_numel=numel[0],
                             embed=[p.dim if p.is_shard() else None for p in
                                    shd.to_placements(specs[0], mesh)])
            runtime_flags.set_variant("baseline")
        print(json.dumps(out))
    """
    out = json.loads(_run(code).strip().splitlines()[-1])
    sharded, whole = out["8"], out["1"]
    # the embedding (first leaf): vocab over "model", d over "data"; on
    # 1 x 1 each rank holds all of it
    assert sharded["embed"] == [1, 0]
    assert sharded["embed_numel"] * 8 == whole["embed_numel"]
    # every leaf's rank-0 slice: params in bf16 and both moments in f32;
    # the batch's tokens and labels split over "data"; the step counter
    for rec, data in ((sharded, 2), (whole, 1)):
        assert rec["argument_size_in_bytes"] == \
            rec["local_numel"] * (2 + 4 + 4) + 2 * 4 * 64 * 4 // data + 4
    assert sharded["temp_size_in_bytes"] < whole["temp_size_in_bytes"]


def test_production_mesh_shapes():
    code = """
        import sys
        sys.path.insert(0, "src")
        import torch.distributed as dist
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import (batch_axes, batch_axis_size,
                                             make_production_mesh,
                                             model_axis_size)
        fake_process_group(256)
        m1 = make_production_mesh()
        assert m1.mesh_dim_names == ("data", "model") and m1.size() == 256
        assert batch_axes(m1) == ("data",) and model_axis_size(m1) == 16
        dist.destroy_process_group()
        fake_process_group(512)
        m2 = make_production_mesh(multi_pod=True)
        assert m2.mesh_dim_names == ("pod", "data", "model")
        assert m2.size() == 512 and tuple(m2.shape) == (2, 16, 16)
        assert batch_axes(m2) == ("pod", "data")
        assert batch_axis_size(m2) == 32
        print("OK mesh")
    """
    assert "OK mesh" in _run(code)


def test_collectives_in_a_loop_count_each_iteration():
    """An all-reduce inside a 7-layer Python loop is 7 x its bytes; an
    all-gather outside it counts once."""
    code = """
        import json, sys
        sys.path.insert(0, "src")
        import torch
        from torch.distributed import _functional_collectives as funcol
        from repro_torch.launch import hlo_analysis as H
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import make_host_mesh
        fake_process_group(8)
        mesh = make_host_mesh(1, 8)

        def step(x):
            g = funcol.all_gather_tensor(x, 0, (mesh, 1))     # (256,) f32
            for _ in range(7):
                x = funcol.all_reduce(x * 2.0, "sum", (mesh, 1))
            return g, x

        _, trace = H.record(step, torch.ones(32))
        print(json.dumps(H.collective_bytes(trace)))
    """
    rec = json.loads(_run(code).strip().splitlines()[-1])
    assert rec["bytes"]["all-reduce"] == 7 * 32 * 4
    assert rec["counts"]["all-reduce"] == 7
    assert rec["bytes"]["all-gather"] == 8 * 32 * 4
    assert rec["total_bytes"] == 7 * 128 + 1024


def test_shape_bytes_and_trace_counts():
    assert H.shape_bytes((4, 8), torch.float32) == 128
    assert H.shape_bytes((2, 2, 2), torch.bfloat16) == 16
    assert H.shape_bytes((), torch.float32) == 4
    assert H.shape_bytes((16,), torch.bool) == 16
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    _, trace = H.record(lambda: (a @ b).t().sum())
    assert H.flops(trace) == 2 * 8 * 16 * 4
    hist = H.op_histogram(trace)
    assert hist["aten.mm"] == 1 and hist["aten.sum"] == 1
    # mm reads 8x16 + 16x4 f32 and writes 8x4; the transpose moves nothing
    mm = [t for t in trace if t.op == "aten.mm"][0]
    assert (mm.in_bytes, mm.out_bytes) == ((128 + 64) * 4, 32 * 4)
    assert all(t.in_bytes == t.out_bytes == 0 for t in trace
               if t.op == "aten.t")


def test_roofline_terms_by_hand():
    rec = {"ok": True, "arch": "qwen3-1.7b", "shape": "train_4k",
           "mesh": "single", "mesh_shape": {"data": 16, "model": 16},
           "flops_per_rank": 2.0e15, "bytes_accessed_per_rank": 6.7e12,
           "collectives": {"bytes": {"all-reduce": 9.0e11,
                                     "all-gather": 4.5e11}}}
    row = roofline.analyze_record(rec)
    assert row.chips == 256
    assert row.compute_s == pytest.approx(2.0e15 / 989.4e12)
    assert row.memory_s == pytest.approx(6.7e12 / 3.35e12)
    assert row.collective_s == pytest.approx((2 * 9.0e11 + 4.5e11) / 450e9)
    assert row.dominant == "collective"
    assert row.hlo_flops == pytest.approx(2.0e15 * 256)
    assert row.useful_ratio == pytest.approx(
        roofline.model_flops("qwen3-1.7b", "train_4k") / (2.0e15 * 256))
    assert roofline.analyze_record({"ok": False}) is None
    assert "| qwen3-1.7b | train_4k |" in roofline.markdown_table([row])


_POD = """
import sys
sys.path.insert(0, "src")
import json, torch
torch.set_num_threads(1)
import repro_torch.configs as C
C.INPUT_SHAPES["tiny_train"] = dict(seq_len=32, global_batch=4, kind="train")
from repro_torch.launch.train import train_pod
history = train_pod("qwen3-1.7b-reduced", "tiny_train", steps=3, cpu=True,
                    log=lambda m: None)
print("LOSSES", json.dumps([h["loss"] for h in history]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_pod_path_two_gloo_ranks_match_one():
    one = subprocess.Popen([sys.executable, "-c", _POD], cwd=ROOT, env=ENV,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    port = _free_port()
    two = [subprocess.Popen(
        [sys.executable, "-c", _POD], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**ENV, "RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in [one] + two]
    finally:
        for p in [one] + two:
            p.kill()
    for p, (_, err) in zip([one] + two, outs):
        assert p.returncode == 0, err[-3000:]
    losses = [json.loads(o.split("LOSSES", 1)[1]) for o, _ in outs]
    assert len(losses[0]) == 3
    assert losses[1] == losses[2]                 # every rank sees the loss
    for a, b in zip(losses[0], losses[1]):
        assert abs(a - b) < 1e-5, (losses[0], losses[1])


def test_train_dry_run_returns_0(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma3-1b", "--shape", "long_500k", "--dry-run"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[OK] gemma3-1b x long_500k x single" in out.stdout
    with open(os.path.join(ROOT, "experiments", "dryrun_torch",
                           "gemma3-1b_long_500k_single.json")) as f:
        mem = json.load(f)["memory_analysis"]
    assert sorted(mem) == ["alias_size_in_bytes", "argument_size_in_bytes",
                           "output_size_in_bytes", "temp_size_in_bytes"]
    assert all(v > 0 for v in mem.values()), mem
