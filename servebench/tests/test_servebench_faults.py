"""A run drives the whole harness on the CPU at a reduced size (the look
for a card skipped): sound, it comes out correct; with the timed path
broken underneath, or with the reference in TF32 in the program's place
(the control), it does not."""
import subprocess
import sys
import time

import pytest
import torch

from harness import cell, check
from servebench_fixtures import ROOT

CPU = torch.device("cpu")


def _member0(system, change):
    """Wrap member 0's forward (the fp32 member: its class scores)."""
    for w in system.workers:
        if w.model_idx == 0:
            fn = w.predict_fn

            def predict(params, tokens, frontend=None, _fn=fn):
                return change(_fn(params, tokens, frontend))
            w.predict_fn = predict


def half_batch(system):
    """Half of each batch left out: its rows get the mean of the rest."""
    def change(out):
        n = out.shape[0] // 2
        out = out.clone()
        out[n:] = out[:n].mean(dim=0)
        return out
    _member0(system, change)


def altered_answer(system):
    """One class score of each batch's first row altered where it is
    produced."""
    def change(out):
        out = out.clone()
        out[0, 7] += 0.5
        return out
    _member0(system, change)


def _run(spec, fault=None, control=False):
    return cell.run_cell(spec, 2 ** 31 + 77, 1.0, False,
                         t_start=time.perf_counter(), device=CPU,
                         fault=fault, control=control)


@pytest.mark.parametrize("workload,open_mix,metrics", [
    ("mamba2-pair.bulk", False, {"rows_per_s", "setup_s"}),
    ("hymba-pair.bulk", False, {"rows_per_s", "setup_s"}),
    ("mamba2-pair.stream", True, {"latency_p95_ms", "latency_p50_ms",
                                  "setup_s"}),
])
def test_sound_run_is_correct(reduced_spec, workload, open_mix, metrics):
    res = _run(reduced_spec(workload, open_mix))
    assert res["correct"], res["numbers"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["sampled_rows"] >= 1
    assert set(res["metrics"]) == metrics


def test_traced_run_reads_the_batcher(reduced_spec):
    """With the profiler on (no device here, so no device metric), the
    stream cell's batcher and dispatch readings."""
    res = cell.run_cell(reduced_spec("mamba2-pair.stream", True), 2 ** 31 + 3,
                        1.0, True, t_start=time.perf_counter(), device=CPU)
    assert res["correct"]
    assert set(res["metrics"]) == {"padding_efficiency.stream",
                                   "rows_per_batch.stream",
                                   "dispatch_wait_ms.stream"}
    assert 0 < res["metrics"]["padding_efficiency.stream"]["value"] <= 100
    assert res["window_s"] == pytest.approx(1.0, abs=0.2)
    assert res["busy_s"] == 0.0


@pytest.mark.parametrize("fault", [half_batch, altered_answer])
@pytest.mark.parametrize("workload", ["mamba2-pair.bulk", "hymba-pair.bulk"])
def test_broken_path_is_not_correct(reduced_spec, workload, fault):
    res = _run(reduced_spec(workload), fault=fault)
    assert not res["correct"], res["numbers"]
    assert res["numbers"]["max_err"] > res["limits"]["max_err"]


@pytest.mark.parametrize("workload", ["mamba2-pair.bulk", "hymba-pair.bulk"])
def test_control_is_not_correct(reduced_spec, workload):
    """The reference in TF32 (emulated on the CPU) in the program's place
    fails a limit that sound runs keep."""
    res = _run(reduced_spec(workload, open_mix=True), control=True)
    assert res["correct"]
    ctl = res["control"]
    assert not check.limits_hold(ctl, res["limits"]), ctl


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, str(ROOT / "servebench" / "run.py"), "--workload",
         "mamba2-pair.bulk", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
