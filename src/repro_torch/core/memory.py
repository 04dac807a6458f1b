"""Memory model: does an allocation matrix fit? (paper's ``fit_mem``).

Per-worker footprint = params + activation workspace (batch-dependent) +
decode KV/SSM cache (batch- and seq-dependent), as in the JAX package.

Param storage is dtype-size-aware: a member executing at int8/fp8 holds its
weights at 1 byte/param (+~3% for the per-channel scales) while activations
stay at the compute dtype.  Pass ``member_dtypes`` (one dtype name per
model, None entries meaning fp32) to the allocation-level predicates.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocation import AllocationMatrix
from repro_torch.kernels.quant import dtype_bytes as _param_dtype_bytes

# per-channel scale overhead of the quantized param layout (one f32 per
# output channel; ~1/32 of the int8 payload at typical channel widths)
_SCALE_OVERHEAD = 1.03


def _param_bytes_per_elem(member_dtype: Optional[str],
                          dtype_bytes: int) -> float:
    """Bytes per param element for a member dtype (None -> the activation
    dtype)."""
    if member_dtype is None:
        return dtype_bytes
    b = _param_dtype_bytes(member_dtype)
    return b * _SCALE_OVERHEAD if b == 1 else b


def worker_bytes(cfg: ModelConfig, batch: int, seq: int,
                 dtype_bytes: int = 4, *, serving_cache_len: int = 0,
                 member_dtype: Optional[str] = None) -> int:
    """Footprint of one worker (one model instance at one batch size)."""
    params = int(cfg.param_count()
                 * _param_bytes_per_elem(member_dtype, dtype_bytes))
    # activation workspace: residual + mixer + mlp peaks per layer (x2 for
    # double-buffering); heads term covers attention q/k/v blocks
    per_tok = (4 * cfg.d_model
               + (cfg.d_ff if cfg.moe is None else
                  cfg.moe.top_k * cfg.moe.d_ff_expert +
                  (cfg.moe.d_ff_shared if cfg.moe.shared_expert else 0))
               + 2 * cfg.num_heads * cfg.hd
               + (2 * cfg.d_inner if cfg.ssm else 0))
    acts = 2 * batch * seq * per_tok * dtype_bytes
    logits = batch * cfg.padded_vocab * dtype_bytes
    cache = cfg.kv_cache_bytes(batch, serving_cache_len or seq, 2) \
        if serving_cache_len else 0
    return params + acts + logits + cache


def device_usage(alloc: AllocationMatrix, cfgs: Sequence[ModelConfig],
                 seq: int, dtype_bytes: int = 4,
                 member_dtypes: Optional[Sequence[Optional[str]]] = None
                 ) -> List[int]:
    """Bytes used per device under matrix ``alloc``."""
    usage = [0] * len(alloc.devices)
    for d, m, batch in alloc.workers():
        usage[d] += worker_bytes(
            cfgs[m], batch, seq, dtype_bytes,
            member_dtype=member_dtypes[m] if member_dtypes else None)
    return usage


def fit_mem(alloc: AllocationMatrix, cfgs: Sequence[ModelConfig], seq: int,
            dtype_bytes: int = 4,
            member_dtypes: Optional[Sequence[Optional[str]]] = None) -> bool:
    """The paper's feasibility predicate."""
    usage = device_usage(alloc, cfgs, seq, dtype_bytes, member_dtypes)
    return all(u <= dev.memory_bytes
               for u, dev in zip(usage, alloc.devices))


def remaining_memory(alloc: AllocationMatrix, cfgs: Sequence[ModelConfig],
                     seq: int, dtype_bytes: int = 4,
                     member_dtypes: Optional[Sequence[Optional[str]]] = None
                     ) -> List[int]:
    usage = device_usage(alloc, cfgs, seq, dtype_bytes, member_dtypes)
    return [dev.memory_bytes - u for u, dev in zip(usage, alloc.devices)]
