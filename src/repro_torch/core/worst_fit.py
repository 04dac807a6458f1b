"""Algorithm 1 — Worst-Fit-Decreasing with priority to GPUs (paper §II.E.1).

Models sorted by decreasing memory size; each is placed (at the minimum batch
size) on the accelerator with the most remaining memory, falling back to the
CPU side only when no accelerator fits, and erroring when nothing fits.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memory as mem
from repro_torch.core.allocation import AllocationMatrix, zeros
from repro_torch.core.devices import DeviceSpec


class AllocationError(RuntimeError):
    """Paper line 24: no device has enough memory."""


def _most_remaining(alloc: AllocationMatrix, cfgs, seq: int,
                    accelerator: bool, member_dtypes=None) -> int:
    remaining = mem.remaining_memory(alloc, cfgs, seq,
                                     member_dtypes=member_dtypes)
    best, best_rem = -1, -1
    for d, dev in enumerate(alloc.devices):
        if dev.is_accelerator != accelerator:
            continue
        if remaining[d] > best_rem:
            best, best_rem = d, remaining[d]
    return best


def worst_fit_decreasing(cfgs: Sequence[ModelConfig],
                         devices: List[DeviceSpec], *,
                         default_batch_size: int = 8,
                         seq: int = 128,
                         member_dtypes=None) -> AllocationMatrix:
    """Returns an allocation with every model placed exactly once.

    ``member_dtypes`` (one dtype name per model, None = fp32) makes the
    footprints dtype-size-aware: int8/fp8 members sort and pack at ~1/4 the
    fp32 param bytes.
    """
    names = [c.name for c in cfgs]
    alloc = zeros(devices, names)

    def mdt(m):
        return member_dtypes[m] if member_dtypes else None

    # sort models in descending order of memory size (offline heuristic)
    order = sorted(range(len(cfgs)),
                   key=lambda m: mem.worker_bytes(cfgs[m], default_batch_size,
                                                  seq, member_dtype=mdt(m)),
                   reverse=True)
    for m in order:
        placed = False
        for accelerator in (True, False):          # GPUs strictly first
            d = _most_remaining(alloc, cfgs, seq, accelerator, member_dtypes)
            if d < 0:
                continue
            cand = alloc.copy()
            cand.A[d, m] = default_batch_size
            if mem.fit_mem(cand, cfgs, seq, member_dtypes=member_dtypes):
                alloc = cand
                placed = True
                break
        if not placed:
            raise AllocationError(
                f"no device has enough memory for {names[m]} "
                f"(batch={default_batch_size})")
    alloc.validate()
    return alloc
