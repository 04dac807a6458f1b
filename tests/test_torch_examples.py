"""The port's examples stay runnable: compile each, run
``torch_generate.py --cpu`` at the size of
tests/test_examples.py::test_generate_runs and
``torch_allocation_search.py`` as test_allocation_search_runs does."""
import os
import py_compile
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = __file__.rsplit("/tests", 1)[0]
EXAMPLES = ["torch_train_lm.py", "torch_generate.py", "torch_quickstart.py",
            "torch_serve_ensemble.py", "torch_allocation_search.py"]
# one torch thread: beside the suite's other workers, one a core
# oversubscribes the host
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "OMP_NUM_THREADS": "1"}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_compiles(name):
    py_compile.compile(os.path.join(ROOT, "examples", name), doraise=True)


def test_allocation_search_runs():
    out = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "examples", "torch_allocation_search.py"),
         "--ensemble", "ENS4", "--gpus", "2", "--max-iter", "2",
         "--max-neighs", "10"],
        capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Algorithm 2" in out.stdout


def test_generate_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_generate.py"),
         "--cpu", "--arch", "musicgen-large", "--steps", "15", "--tokens",
         "8"],
        capture_output=True, text=True, timeout=500,
        env=ENV)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "generated:" in out.stdout
    # the decode steps went through the decode-attention entry (its plain
    # version on the CPU)
    assert "'decode_attention': 16" in out.stdout


def test_train_lm_runs_on_the_cpu_and_resumes(tmp_path):
    def run(*extra):
        return subprocess.run(
            [sys.executable,
             os.path.join(ROOT, "examples", "torch_train_lm.py"), "--cpu",
             "--steps", "3", "--batch", "4", "--seq", "16", "--d-model",
             "64", *extra],
            capture_output=True, text=True, timeout=300,
            env={**ENV, "TMPDIR": str(tmp_path)})
    # the default checkpoint directory lies under the caller's TMPDIR
    out = run()
    assert out.returncode == 0, out.stderr[-2000:]
    assert "checkpoint ->" in out.stdout
    ck = tmp_path / "repro_torch_ckpt"
    assert (ck / "step_3" / "arrays.npz").exists()
    out = run("--resume", "--ckpt-dir", str(ck))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed from step 3" in out.stdout
