"""The port's dry-run tooling: every reduced architecture's train and decode
steps traced sharded on a fake 2 x 4 mesh (registered as
tests/test_dryrun_small.py registers them), the production mesh shapes, the
trace analysis (a collective inside a 7-layer loop counts 7 times), the
roofline's three terms by hand, the training launcher's pod path on 2
``gloo`` ranks against 1 rank, and ``--dry-run``.  Every fake or gloo group
lives in a subprocess of its own, with its own timeout."""
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
    """{arch: {shape: (flops per rank, collective bytes, ops)}} from one
    subprocess on a fake 8-rank group."""
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
        fake_process_group(8)
        mesh = make_host_mesh(2, 4)
        out = {{}}
        for arch in {list_architectures()!r}:
            cfg = get_config(arch).reduced()
            out[arch] = {{}}
            for shape in ("tiny_train", "tiny_decode"):
                tr = lower_step(cfg, shape, mesh)
                out[arch][shape] = [H.flops(tr.trace),
                                    H.collective_bytes(tr.trace)["total_bytes"],
                                    len(tr.trace), tr.argument_bytes]
        print(json.dumps(out))
    """
    return json.loads(_run(code, timeout=400).strip().splitlines()[-1])


@pytest.mark.parametrize("arch", list_architectures())
def test_small_mesh_trace(small_mesh_traces, arch):
    for shape in ("tiny_train", "tiny_decode"):
        flops, coll, ops, args = small_mesh_traces[arch][shape]
        assert flops > 0, (arch, shape)
        assert ops > 0 and args > 0, (arch, shape)
    # the train step reduces its gradients over the mesh
    assert small_mesh_traces[arch]["tiny_train"][1] > 0


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
