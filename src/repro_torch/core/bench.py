"""``bench(A, calib_data) -> throughput`` — the greedy's scoring function.

Two backends, as in the JAX package:

* ``MeasuredBench`` — the paper's: instantiate the inference system in
  Benchmark Mode on calibration samples and time it.  It builds the system
  with its defaults (``use_kernel=False``, ``combine="mean"``), as the JAX
  package's does, so its rows/s are those of the default system.
* ``AnalyticBench`` — a roofline cost model evaluated from the configs and
  the device cells' ``peak_flops`` and ``mem_bw``.

Both return samples/sec, and 0.0 for infeasible matrices (paper's convention).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memory as mem
from repro_torch.core.allocation import AllocationMatrix

Bench = Callable[[AllocationMatrix], float]


def per_model_throughput(alloc: AllocationMatrix,
                         worker_time: Callable[[int, int, int], float]
                         ) -> list:
    """The shared cycle model: co-located workers time-share their device
    round-robin (a device's cycle time is the sum of its workers'
    latencies) and a model's throughput adds over its data-parallel
    instances.  ``worker_time(d, m, batch)`` supplies the per-batch
    latency."""
    cycle = [0.0] * len(alloc.devices)
    for d, m, b in alloc.workers():
        cycle[d] += worker_time(d, m, b)
    per_model = [0.0] * len(alloc.model_names)
    for d, m, b in alloc.workers():
        per_model[m] += b / cycle[d]
    return per_model


class AnalyticBench:
    """Roofline throughput model.

    Worker latency per cycle: t = overhead + max(compute, memory) where
      compute = batch * seq * flops_per_token / peak_flops
      memory  = (params_bytes + batch * act_bytes) / mem_bw
    Co-located workers time-share their device round-robin: a device's cycle
    time is the sum of its workers' latencies, and a worker completes
    ``batch`` samples per cycle.  A model's throughput adds over its
    data-parallel instances; the ensemble's throughput is the min over models
    (every member must predict every sample).
    """

    def __init__(self, cfgs: Sequence[ModelConfig], *, seq: int = 128,
                 dtype_bytes: int = 4, overhead_s: float = 2e-4,
                 member_dtypes: Optional[Sequence[Optional[str]]] = None):
        self.cfgs = list(cfgs)
        self.seq = seq
        self.dtype_bytes = dtype_bytes
        self.overhead_s = overhead_s
        # per-member execution dtype: narrows both the roofline's
        # param-streaming term and the fit_mem footprint
        self.member_dtypes = list(member_dtypes) if member_dtypes else None
        self.calls = 0

    def bytes_moved(self, cfg: ModelConfig, batch: int,
                    member_dtype: Optional[str] = None) -> float:
        """The roofline's memory term: streamed param bytes (narrowed by the
        member dtype) plus fp32 activation traffic."""
        act_per_tok = (2 * cfg.d_model + (cfg.d_ff or 2 * cfg.d_model)) * self.dtype_bytes
        param_bytes = mem._param_bytes_per_elem(member_dtype, self.dtype_bytes)
        return (cfg.active_param_count() * param_bytes
                + batch * self.seq * act_per_tok)

    def worker_time(self, dev, cfg: ModelConfig, batch: int,
                    member_dtype: Optional[str] = None) -> float:
        flops = batch * self.seq * cfg.flops_per_token(self.seq)
        bytes_moved = self.bytes_moved(cfg, batch, member_dtype)
        return self.overhead_s + max(flops / dev.peak_flops,
                                     bytes_moved / dev.mem_bw)

    def _member_dtype(self, m: int) -> Optional[str]:
        return self.member_dtypes[m] if self.member_dtypes else None

    def __call__(self, alloc: AllocationMatrix) -> float:
        self.calls += 1
        if not alloc.is_valid():
            return 0.0
        if not mem.fit_mem(alloc, self.cfgs, self.seq, self.dtype_bytes,
                           member_dtypes=self.member_dtypes):
            return 0.0
        per_model = per_model_throughput(
            alloc, lambda d, m, b: self.worker_time(alloc.devices[d],
                                                    self.cfgs[m], b,
                                                    self._member_dtype(m)))
        return min(per_model)


class MeasuredBench:
    """The paper's offline benchmark: build the inference system for ``alloc``
    in Benchmark Mode, push the calibration samples through, time it."""

    def __init__(self, cfgs: Sequence[ModelConfig], params_list, calib_x,
                 *, segment_size: int = 128, repeats: int = 1,
                 frontends: Optional[dict] = None):
        self.cfgs = list(cfgs)
        self.params_list = params_list
        self.calib_x = calib_x
        self.segment_size = segment_size
        self.repeats = repeats
        self.frontends = frontends or {}
        self.calls = 0

    def __call__(self, alloc: AllocationMatrix) -> float:
        from repro_torch.serving.system import InferenceSystem  # no cycle
        self.calls += 1
        if not alloc.is_valid():
            return 0.0
        if not mem.fit_mem(alloc, self.cfgs, self.calib_x.shape[1]):
            return 0.0
        try:
            system = InferenceSystem(self.cfgs, self.params_list, alloc,
                                     segment_size=self.segment_size,
                                     frontends=self.frontends)
        except MemoryError:
            return 0.0
        try:
            _, throughput = system.benchmark(self.calib_x, repeats=self.repeats)
        finally:
            system.shutdown()
        return throughput


class MemoBench:
    """Memoizing wrapper: identical matrices are scored once.  The paper
    re-runs the benchmark on revisits."""

    def __init__(self, inner: Bench):
        self.inner = inner
        self.cache: Dict[str, float] = {}
        self.hits = 0

    def __call__(self, alloc: AllocationMatrix) -> float:
        k = alloc.key()
        if k in self.cache:
            self.hits += 1
            return self.cache[k]
        v = self.inner(alloc)
        self.cache[k] = v
        return v
