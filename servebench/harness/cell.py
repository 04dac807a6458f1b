"""One run of one cell: set-up, the measured window, the check.

A cell names a configuration file (``servebench/configs/<config>.json``)
and a traffic mix (``servebench/traffic/<traffic>.json``); its metrics are
the entries of ``BENCHMARK.json`` that list it (or list no cells), each
read by ``servebench/metrics/<name>.py``.  The configuration names its
family module (``harness/family.py``), which draws, counts and checks its
layers.  Nothing here names a cell, a configuration, a layer kind or a
metric.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import threading
import time
import typing
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from harness import check, devtrace, family, stats, traffic, weights, work

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def log(msg: str) -> None:
    print(f"[servebench] {msg}", file=sys.stderr, flush=True)


def load_config(name: str, root: Path = ROOT) -> dict:
    """``servebench/configs/<name>.json``."""
    return json.loads((root / "servebench" / "configs" / f"{name}.json")
                      .read_text())


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration, its traffic and its metrics."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]

    def mine(entries):
        return [m for m in entries
                if workload in m.get("workloads", [workload])]
    return {"cell": cell,
            "cfg": load_config(cell["config"], root),
            "traffic": json.loads((root / "servebench" / "traffic" /
                                   f"{cell['traffic']}.json").read_text()),
            "end_to_end": mine(manifest["end_to_end"]),
            "per_layer": mine(manifest["per_layer"])}


def reader_path(name: str) -> Path:
    """``servebench/metrics/<name>.py``, or where there is none, the file of
    the name without its last dotted part, and so on: one reader serves
    ``device_idle_share.bulk`` and ``device_idle_share.stream``."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = BENCH / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{BENCH / 'metrics'}")


def reader(name: str) -> Callable:
    """``read(ctx)`` of the metric's reader (``reader_path``)."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "servebench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_models(cfg: dict) -> list:
    """The program's model configurations of the ensemble's members: every
    key of the file that ``ModelConfig`` has, a nested group (``ssm``,
    ``moe``) as its dataclass, a list as a tuple; each member's depth and
    name its own."""
    from repro_torch.configs.base import ModelConfig
    hints = typing.get_type_hints(ModelConfig)
    base = {}
    for f in dataclasses.fields(ModelConfig):
        if f.name not in cfg or f.name in ("name", "num_layers"):
            continue
        v = cfg[f.name]
        if isinstance(v, dict):
            v = next(a for a in typing.get_args(hints[f.name])
                     if dataclasses.is_dataclass(a))(**v)
        elif isinstance(v, list):
            v = tuple(v)
        base[f.name] = v
    return [ModelConfig(name=f"{cfg['name']}.m{i}", num_layers=m["num_layers"],
                        **base)
            for i, m in enumerate(cfg["members"])]


def build_system(cfg: dict, trees, device: torch.device, tracing: bool):
    """Deploy Mode as the cell runs it: the fused combine and the kernels,
    the device partial combine and the coalescing batcher at their
    defaults, no supervision, no brownout."""
    from repro_torch.core import AllocationMatrix, cuda_devices, host_cpus
    from repro_torch.serving import InferenceSystem
    cells = cuda_devices()[:1] if device.type == "cuda" else host_cpus(1)
    models = port_models(cfg)
    alloc = AllocationMatrix(cells, [m.name for m in models],
                             np.array(cfg["allocation"]))
    return InferenceSystem(
        models, trees, alloc, combine="pallas", use_kernel=True,
        weights=np.array([m["weight"] for m in cfg["members"]], np.float32),
        max_seq=cfg["max_seq"], segment_size=cfg["segment_size"],
        member_dtypes=[m["dtype"] for m in cfg["members"]], tracing=tracing)


def _annotate(system, spans: list) -> None:
    """Keep the host span of each member's forward (the enqueue of its
    kernels) in ``spans``, for the idle gaps' names."""
    for w in system.workers:
        fn, tag = w.predict_fn, f"servebench: member {w.model_idx} forward"

        def predict(params, tokens, frontend=None, _fn=fn, _tag=tag):
            t = time.perf_counter()
            try:
                return _fn(params, tokens, frontend)
            finally:
                spans.append((t, time.perf_counter(), _tag))
        w.predict_fn = predict


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: torch.device,
             fault: Optional[Callable] = None,
             control: bool = False) -> dict:
    """Set up, measure ``seconds``, check.  ``fault(system)`` breaks the
    timed path underneath (tests); ``control`` also compares the
    reference computed in TF32 with the float32 one.  Returns the result
    line's fields and the numbers compared."""
    cfg, mix = spec["cfg"], spec["traffic"]
    fam = family.module(cfg)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    log(f"set-up: {t - t_start:.3f} s to the first weight")
    trees = weights.make_trees(cfg, seed, device)
    _sync(device)
    log(f"set-up: weights {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    system = build_system(cfg, trees, device, tracing=trace)
    log(f"set-up: system built and warmed {time.perf_counter() - t:.3f} s")
    host_spans: list = []
    try:
        if fault is not None:
            fault(system)
        t = time.perf_counter()
        traffic.warm(system, mix, cfg)
        log(f"set-up: warm-up requests {time.perf_counter() - t:.3f} s")
        if trace:
            _annotate(system, host_spans)
        from repro_torch.kernels import ops
        _sync(device)
        system.timers.reset()
        ops.reset_counts()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
        from torch.profiler import record_function
        with record_function(devtrace.MARK_START):
            t0 = time.perf_counter()
        setup_s = t0 - t_start
        out: list = []
        th = threading.Thread(target=lambda: out.extend(traffic.run(
            system, mix, cfg, seed, t0, seconds)), name="servebench-traffic")
        th.start()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        with record_function(devtrace.MARK_END):
            t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
        th.join()
        counters = system.serving_counters()
        stages = system.stage_timings()
        plain = sum(ops.plain_calls().values())
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    finally:
        system.shutdown()
    del system
    _free(device)
    t = time.perf_counter()
    red = devtrace.reduce(prof, host_spans, t0) if prof is not None else None
    if red is not None:
        log(f"trace reduced in {time.perf_counter() - t:.3f} s")
    del prof
    reqs = out
    failed = [r for r in reqs if not r.ok]
    late = [r.sent - r.due for r in reqs if r.sent is not None]
    if late:
        log(f"generator lateness: max {1e3 * max(late):.3f} ms, p95 "
            f"{1e3 * stats.percentile(late, 95):.3f} ms over {len(late)} "
            f"requests")
    for r in failed[:5]:
        log(f"request {r.idx} ({r.rows} rows) failed: {r.error}")

    # the check, once the program's state is freed
    picked = check.sample(reqs, seed)
    numbers: Dict[str, float] = {}
    control_numbers = None
    if picked:
        X = torch.from_numpy(np.concatenate([r.X for r in picked])).to(device)
        Y = torch.from_numpy(np.concatenate([r.Y for r in picked])).to(device)
        t = time.perf_counter()
        ref = fam.combined(cfg, trees, X)
        _sync(device)
        log(f"reference: {X.shape[0]} rows in {time.perf_counter() - t:.3f} s")
        numbers = check.compare(Y, ref, cfg["members"])
        if control:
            ctl = fam.combined(cfg, trees, X, prec="tf32")
            control_numbers = check.compare(ctl["Y"], ref, cfg["members"])
        del X, Y, ref
    del trees
    _free(device)
    limits = dict(cfg["check"])
    if device.type == "cuda":
        numbers["plain_calls"] = float(plain)
        limits["plain_calls"] = 0.0
    if picked and "alt_share" in limits:    # a module that named none
        for nums in filter(None, (numbers, control_numbers)):
            nums.setdefault("alt_share", 0.0)
    unlimited = [k for k in numbers if k not in limits]
    for k in unlimited:
        log(f"check {k} has no limit in the configuration: not correct")
    correct = bool(picked) and not failed and not unlimited and \
        check.limits_hold(numbers, limits)

    done = [r for r in reqs if r.ok]
    rate = stats.completion_rate([r.due for r in done],
                                 [r.done for r in done],
                                 [r.rows for r in done], t0, t1)
    whole = [r for r in done if t0 <= r.done <= t1]
    log(f"answered in the window: {len(whole)} requests, "
        f"{sum(r.rows for r in whole)} rows; served {rate:.4f} rows/s")
    ctx = SimpleNamespace(
        cfg=cfg, traffic=mix, cell=spec["cell"], requests=reqs, t0=t0, t1=t1,
        setup_s=setup_s, rows_per_s=rate, counters=counters, stages=stages,
        trace=red, work=work, devtrace=devtrace, stats=stats)
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in entries:
        v = reader(m["name"])(ctx)
        if v is None:
            continue
        if not math.isfinite(v):
            correct = False
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    res = {"correct": correct, "attempted": len(reqs), "failed": len(failed),
           "metrics": metrics, "peak": peak, "numbers": numbers,
           "limits": limits, "control": control_numbers,
           "sampled_rows": sum(r.rows for r in picked)}
    if red is not None:
        res["busy_s"], res["window_s"] = red["busy_s"], red["window_s"]
        res["breakdown"] = devtrace.breakdown(red)
    return res
