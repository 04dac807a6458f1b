"""The allocation matrix and the device cells it places workers on."""
from repro_torch.core.allocation import (DEFAULT_BATCH_SIZES, AllocationMatrix,
                                         zeros)
from repro_torch.core.devices import DeviceSpec, cuda_devices, host_cpus

__all__ = ["AllocationMatrix", "zeros", "DEFAULT_BATCH_SIZES", "DeviceSpec",
           "cuda_devices", "host_cpus"]
