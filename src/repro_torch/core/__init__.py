"""The paper's primary contribution: the allocation matrix, its optimizer
(worst-fit-decreasing + bounded greedy), the bench backends, and the BBS
baseline."""
from repro_torch.core.allocation import (DEFAULT_BATCH_SIZES, AllocationMatrix,
                                         zeros)
from repro_torch.core.bbs import best_batch_strategy
from repro_torch.core.bench import AnalyticBench, MeasuredBench, MemoBench
from repro_torch.core.devices import (DeviceSpec, cuda_cells, cuda_devices,
                                      host_cpus, simulated_gpus)
from repro_torch.core.greedy import bounded_greedy
from repro_torch.core.optimizer import AllocationOptimizer, OptimizationResult
from repro_torch.core.worst_fit import AllocationError, worst_fit_decreasing

__all__ = [
    "AllocationMatrix", "zeros", "DEFAULT_BATCH_SIZES", "DeviceSpec",
    "cuda_cells", "cuda_devices", "host_cpus", "simulated_gpus", "AnalyticBench",
    "MeasuredBench", "MemoBench", "worst_fit_decreasing", "AllocationError",
    "bounded_greedy", "AllocationOptimizer", "OptimizationResult",
    "best_batch_strategy",
]
