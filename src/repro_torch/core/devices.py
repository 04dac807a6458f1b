"""Device abstraction for the allocation problem (PyTorch port).

The paper's "device" is one GPU or CPU socket.  A device here is an
**allocation cell**: ``torch_device`` names the backing runtime device.
Several logical cells may map to the one card (or the one CPU), each with its
own memory budget, which is what the allocation algorithms reason about.

``cuda_devices()`` reads the real cards and raises when there are none: an
entry point that asked for the card never runs on the CPU instead.
``cuda_cells(n)`` splits each card into ``n`` cells: the counterpart of
the JAX package's ``tpu_cells`` and of its launcher's ``--cells`` on one
device.  Tests ask for the CPU explicitly through ``host_cpus()``, and
``simulated_gpus()`` gives cells with no device behind them for the
allocator's analytic bench.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

GiB = 1024 ** 3

# Host figures for CPU cells (only the allocator's analytic bench reads them)
HOST_PEAK_FLOPS = 1.5e12
HOST_BW = 80e9

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, from the data sheet: f32
# on the CUDA cores and the HBM3 rate, the figures chip_smoke.py's bounds
# use.  A card's memory is read from the card itself.
H100_PEAK_FLOPS = 67e12
H100_HBM_BW = 3.35e12
# (peak flops, memory bytes/s) by the card's full name, as
# torch.cuda.get_device_name gives it: only the card these rates are for (an
# H100 PCIe or NVL has other rates)
CARD_RATES = {"NVIDIA H100 80GB HBM3": (H100_PEAK_FLOPS, H100_HBM_BW)}


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


def simulated_gpus(n: int, memory_bytes: int,
                   peak_flops: float = H100_PEAK_FLOPS,
                   mem_bw: float = H100_HBM_BW) -> list:
    """``n`` GPU cells with no device behind them (the allocator reasons
    about them; only fake workers run there), at the H100 row's rates
    unless given."""
    return [DeviceSpec(f"gpu{i}", "GPU", memory_bytes, peak_flops, mem_bw)
            for i in range(n)]


def host_cpus(n: int = 1, memory_bytes: int = 16 * GiB) -> list:
    """CPU cells, all backed by the host CPU."""
    return [DeviceSpec(f"cpu{i}", "CPU", memory_bytes, HOST_PEAK_FLOPS, HOST_BW,
                       torch_device=torch.device("cpu")) for i in range(n)]


def cuda_devices() -> list:
    """One cell per visible CUDA card, with its name and memory read from
    ``torch.cuda.get_device_properties``.  Raises when there is no card.

    ``peak_flops`` and ``mem_bw`` come from ``CARD_RATES`` by the card's
    full name, and are 0 for a card that has no row there."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_devices(): no CUDA device is available")
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        peak, bw = CARD_RATES.get(props.name, (0.0, 0.0))
        out.append(DeviceSpec(f"cuda{i}:{props.name}", "GPU",
                              int(props.total_memory), peak, bw,
                              torch_device=torch.device("cuda", i)))
    return out


def cuda_cells(n: int) -> list:
    """``n`` allocation cells per visible CUDA card, each backed by that
    card and holding 1/n of its memory and 1/n of its ``CARD_RATES``, so
    that no allocator or analytic bench counts the card twice.  Each cell
    has its own name (``cuda0.1:<card name>``), hence its own ``key()``: a
    live bench keys its readings on it.  Raises when there is no card.

    Each cell's budget is checked alone; the cells share the card's memory
    and its one stream in fact, so a cell may fail to allocate (a
    ``torch.cuda.OutOfMemoryError``) while its own budget has room."""
    if n < 1:
        raise ValueError(f"cuda_cells(): n must be >= 1, got {n}")
    out = []
    for card in cuda_devices():
        i = card.torch_device.index
        out += [DeviceSpec(f"cuda{i}.{j}:{card.name.split(':', 1)[1]}", "GPU",
                           card.memory_bytes // n, card.peak_flops / n,
                           card.mem_bw / n, torch_device=card.torch_device)
                for j in range(n)]
    return out
