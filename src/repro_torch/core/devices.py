"""Device abstraction for the allocation problem (PyTorch port).

The paper's "device" is one GPU or CPU socket.  A device here is an
**allocation cell**: ``torch_device`` names the backing runtime device.
Several logical cells may map to the one card (or the one CPU), each with its
own memory budget, which is what the allocation algorithms reason about.

``cuda_devices()`` reads the real cards and raises when there are none: an
entry point that asked for the card never runs on the CPU instead.  Tests ask
for the CPU explicitly through ``host_cpus()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

GiB = 1024 ** 3

# Host figures for CPU cells (only the allocator's analytic bench reads them)
HOST_PEAK_FLOPS = 1.5e12
HOST_BW = 80e9


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    kind: str                        # "GPU" | "CPU"
    memory_bytes: int
    peak_flops: float
    mem_bw: float
    torch_device: Optional[torch.device] = None   # None = simulated cell

    @property
    def is_accelerator(self) -> bool:
        return self.kind == "GPU"

    def key(self) -> str:
        return f"{self.kind}:{self.name}:{self.memory_bytes}"


def host_cpus(n: int = 1, memory_bytes: int = 16 * GiB) -> list:
    """CPU cells, all backed by the host CPU."""
    return [DeviceSpec(f"cpu{i}", "CPU", memory_bytes, HOST_PEAK_FLOPS, HOST_BW,
                       torch_device=torch.device("cpu")) for i in range(n)]


def cuda_devices() -> list:
    """One cell per visible CUDA card, with its name and memory read from
    ``torch.cuda.get_device_properties``.  Raises when there is no card.

    ``peak_flops`` and ``mem_bw`` are 0: the port states no rate it has not
    measured on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_devices(): no CUDA device is available")
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append(DeviceSpec(f"cuda{i}:{props.name}", "GPU",
                              int(props.total_memory), 0.0, 0.0,
                              torch_device=torch.device("cuda", i)))
    return out
