"""The Best-Batch-Size (BBS) baseline (paper §I.A, Table III).

One model per accelerator (requires as many accelerators as models — the
paper calls out this rigidity).  Each model's batch size is scanned
*independently* with a single-model benchmark, like the model-analyzer-style
tools the paper cites.  ``#bench == M * |batch_sizes|``.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocation import (DEFAULT_BATCH_SIZES, AllocationMatrix,
                                         zeros)
from repro_torch.core.devices import DeviceSpec

# (cfg, device, batch) -> samples/sec of that model alone on that device
SingleBench = Callable[[ModelConfig, DeviceSpec, int], float]


class BBSError(RuntimeError):
    pass


def analytic_single_bench(seq: int = 128, dtype_bytes: int = 4,
                          overhead_s: float = 2e-4) -> SingleBench:
    """Single-model roofline bench consistent with core.bench.AnalyticBench
    (returns 0 when the worker doesn't fit the device, like the paper's
    bench on an OOM)."""
    from repro_torch.core.bench import AnalyticBench
    from repro_torch.core.memory import worker_bytes

    def fn(cfg: ModelConfig, dev: DeviceSpec, batch: int) -> float:
        if worker_bytes(cfg, batch, seq, dtype_bytes) > dev.memory_bytes:
            return 0.0
        ab = AnalyticBench([cfg], seq=seq, dtype_bytes=dtype_bytes,
                           overhead_s=overhead_s)
        return batch / ab.worker_time(dev, cfg, batch)
    return fn


def measured_single_bench(params_for: Callable[[ModelConfig], object],
                          calib_x, segment_size: int = 128) -> SingleBench:
    """Single-model measured bench (builds a 1-model inference system)."""
    def fn(cfg: ModelConfig, dev: DeviceSpec, batch: int) -> float:
        from repro_torch.serving.system import InferenceSystem
        alloc = AllocationMatrix([dev], [cfg.name], np.array([[batch]]))
        system = InferenceSystem([cfg], [params_for(cfg)], alloc,
                                 segment_size=segment_size)
        try:
            _, thr = system.benchmark(calib_x)
        finally:
            system.shutdown()
        return thr
    return fn


def best_batch_strategy(cfgs: Sequence[ModelConfig],
                        devices: List[DeviceSpec],
                        bench_single: SingleBench, *,
                        batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES
                        ) -> Tuple[AllocationMatrix, int]:
    """Returns (allocation, number of bench calls)."""
    accels = [d for d, dev in enumerate(devices) if dev.is_accelerator]
    if len(accels) < len(cfgs):
        raise BBSError(
            f"BBS needs >= {len(cfgs)} accelerators, got {len(accels)} "
            "(the baseline's rigidity — see paper §IV.C)")
    names = [c.name for c in cfgs]
    final = zeros(devices, names)
    nbench = 0
    for m, cfg in enumerate(cfgs):
        d = accels[m]
        best_b, best_s = batch_sizes[0], -1.0
        for b in batch_sizes:
            s = bench_single(cfg, devices[d], b)
            nbench += 1
            if s > best_s:
                best_b, best_s = b, s
        final.A[d, m] = best_b
    final.validate()
    return final, nbench
