"""The readers of the program's own stages: each on a synthetic context,
its value, and no value without its stage or without device time in the
traced run (the CPU)."""
from types import SimpleNamespace

import pytest

from harness import cell


def _stage(total_s, count):
    return {"total_s": total_s, "count": count,
            "mean_ms": 1e3 * total_s / max(count, 1)}


def _ctx(stages=None, counters=None, busy_s=40.0):
    trace = None if busy_s is None else {"busy_s": busy_s, "window_s": 51.0}
    return SimpleNamespace(stages=stages or {}, counters=counters or {},
                           trace=trace)


METRICS = ["device_queue_ms.stream", "admission_wait_ms.stream"]


def test_device_queue_ms_pools_the_members_chunks():
    read = cell.reader("device_queue_ms.stream")
    ctx = _ctx({"device_queue.m0": _stage(3.0, 10),
                "device_queue.m1": _stage(1.0, 30),
                "dispatch_wait.normal": _stage(50.0, 40)})
    assert read(ctx) == pytest.approx(1e3 * 4.0 / 40)
    assert read(_ctx({"dispatch_wait.normal": _stage(50.0, 40)})) is None


@pytest.mark.parametrize("metric,stage", [
    ("admission_wait_ms.stream", "admission_wait"),
])
def test_mean_of_one_stage(metric, stage):
    read = cell.reader(metric)
    assert read(_ctx({stage: _stage(0.5, 4), "combine": _stage(9.0, 3)})) \
        == pytest.approx(125.0)
    assert read(_ctx({"combine": _stage(9.0, 3)})) is None
    assert read(_ctx({stage: _stage(0.0, 0)})) is None


def test_device_queue_ms_pools_only_its_own_stages():
    read = cell.reader("device_queue_ms.stream")
    ctx = _ctx({"device_queue.m0": _stage(1.0, 2),
                "device_queue.m3": _stage(2.0, 2),
                "device_queued": _stage(50.0, 1),
                "forward_device.m0.b8": _stage(50.0, 1)})
    assert read(ctx) == pytest.approx(1e3 * 3.0 / 4)


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_is_its_own_file(metric):
    assert cell.reader_path(metric).name == metric + ".py"


@pytest.mark.parametrize("busy_s", [None, 0.0])
@pytest.mark.parametrize("metric", METRICS)
def test_no_reading_without_device_time(metric, busy_s):
    stages = {k: _stage(1.0, 4) for k in (
        "device_queue.m0", "admission_wait")}
    read = cell.reader(metric)
    assert read(_ctx(stages)) is not None
    assert read(_ctx(stages, busy_s=busy_s)) is None


@pytest.mark.parametrize("metric,stage", [
    ("admission_wait_ms.stream", "admission_wait"),
    ("device_queue_ms.stream", "device_queue.m0"),
])
@pytest.mark.parametrize("case", ["untraced", "no-device-time", "no-sample"])
def test_none_without_a_reading(metric, stage, case):
    read = cell.reader(metric)
    if case == "no-sample":
        ctx = _ctx({stage: _stage(0.0, 0)})
    else:
        ctx = _ctx({stage: _stage(1.0, 2)},
                   busy_s=None if case == "untraced" else 0.0)
    assert read(ctx) is None


# the stages a program without its own waits recorded (before they were
# added): the readers read nothing there, and raise nothing
OLDER_STAGES = ("accumulate", "batch_fill", "batcher_wait", "combine",
                "dispatch_wait.normal", "predict", "transfer")


@pytest.mark.parametrize("metric", METRICS)
def test_no_reading_from_a_program_without_the_stages(metric):
    read = cell.reader(metric)
    assert read(_ctx({k: _stage(1.0, 4) for k in OLDER_STAGES},
                     {"rows_valid": 64.0})) is None
