"""Reduce a ``torch.profiler`` trace of the window to what the per-layer
metrics read: device operations by name, the device's busy time (the
union of every device-side interval, merged across streams), and the idle
gaps with what the host was doing in them.

Only device-side events are summed: an aten op's own entry repeats the
time of the kernels it launched.  The window's bounds are two marks the
harness records in its own thread when the profiler starts and stops.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

MARK_START = "servebench.window.start"
MARK_END = "servebench.window.end"
TOP = 10

_MATMUL = re.compile(r"gemm|gemv|splitkreduce|cublas|cutlass|xmma", re.I)
_PORT = re.compile(r"\b(ssd_\w*kernel|flash_kernel|combine_kernel|"
                   r"combine_quant_kernel|decode_\w*kernel)\b")
_TRANSFER = re.compile(r"Memcpy (HtoD|DtoH)")


def is_matmul(name: str) -> bool:
    """A cuBLAS product (GEMM, GEMV or its split-K reduction)."""
    return bool(_MATMUL.search(name)) and not _PORT.search(name)


def is_port_kernel(name: str) -> bool:
    """One of the program's own CUDA kernels."""
    return bool(_PORT.search(name))


def is_transfer(name: str) -> bool:
    """A copy between host and device."""
    return bool(_TRANSFER.search(name))


def _span(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        return float(e.start_ns()), float(e.start_ns() + e.duration_ns())
    return 1e3 * e.start_us(), 1e3 * (e.start_us() + e.duration_us())


def _merge(spans: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def reduce(prof, spans=(), t0: float = 0.0) -> dict:
    """``{"window_s", "busy_s", "ops": {name: [seconds, count]},
    "idle_gaps": [[host activity, seconds], ...]}`` of the traced window;
    ``ops`` and ``busy_s`` cover device intervals clipped to it.
    ``spans`` are the harness's own host spans (perf_counter start, end,
    name); ``t0`` is the perf_counter reading taken inside the start mark,
    which places them on the profiler's clock."""
    from torch.autograd import DeviceType
    device, host = [], []
    marks: Dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        lo, hi = _span(e)
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            device.append((lo, hi, name))
        else:
            if name in (MARK_START, MARK_END):
                marks[name] = lo
            elif hi > lo:
                host.append((lo, hi, name))
    if MARK_START not in marks or MARK_END not in marks:
        raise RuntimeError("the profiler recorded no window marks")
    w0, w1 = marks[MARK_START], marks[MARK_END]
    host += [(w0 + (a - t0) * 1e9, w0 + (b - t0) * 1e9, n)
             for a, b, n in spans]
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    on_device = []
    for lo, hi, name in device:
        lo, hi = max(lo, w0), min(hi, w1)
        if hi <= lo:
            continue
        ops[name][0] += (hi - lo) * 1e-9
        ops[name][1] += 1
        on_device.append((lo, hi))
    busy = _merge(on_device)
    busy_ns = sum(hi - lo for lo, hi in busy)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "ops": dict(ops), "idle_gaps": _gaps(busy, host, w0, w1)}


def _gaps(busy, host, w0: float, w1: float) -> List[list]:
    """Idle time of the window by the host activity in progress when the
    device went idle: the innermost host event (the latest to start) that
    spans the gap's start, on any thread.  Summed by name, longest first."""
    edges = [w0] + [x for lo, hi in busy for x in (lo, hi)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted(host)
    starts = [h[0] for h in host]
    by_name: Dict[str, float] = defaultdict(float)
    for lo, hi in gaps:
        i = bisect.bisect_right(starts, lo)
        name = "no host event recorded"
        # the latest-starting event that is still running at ``lo``; events
        # nest, so a short scan back finds it or an enclosing one
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][1] > lo:
                name = host[j][2]
                break
        by_name[name] += (hi - lo) * 1e-9
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])]


def breakdown(red: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle time by host activity, at most 10 each."""
    ops = sorted(red["ops"].items(), key=lambda x: -x[1][0])[:TOP]
    return {"device_ops": [[n, v[0]] for n, v in ops],
            "idle_gaps": red["idle_gaps"][:TOP]}


def seconds_where(red: dict, pred) -> Tuple[float, int]:
    """Device seconds and count of the operations whose name ``pred``
    accepts."""
    s, n = 0.0, 0
    for name, (sec, cnt) in red["ops"].items():
        if pred(name):
            s += sec
            n += cnt
    return s, n
