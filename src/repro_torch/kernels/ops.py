"""Public kernel entries, with the JAX package's signatures.

Dispatch is by the tensors' device: a CPU tensor goes to the plain version in
``ref.py``, a CUDA tensor to the Hopper kernel, which launches or raises.
Unlike the TPU wrappers nothing is padded: the kernels mask ragged edges
themselves.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ensemble_combine as _comb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref


def pow2_clamp(n: int, lo: int, hi: int) -> int:
    """Next power of two >= n, clamped to [lo, hi] (block-size selection)."""
    return min(hi, max(lo, 1 << max(n - 1, 1).bit_length()))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd); scale 1/sqrt(hd).

    q is scaled before the kernel in its own dtype, with the scale itself
    rounded to that dtype first, exactly as the JAX wrapper's weakly-typed
    ``q * hd**-0.5`` does (in bf16 this rounds q, and parity depends on it)."""
    hd = q.shape[3]
    scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
    return _fa.flash_attention((q * scale).contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window)


def ensemble_combine(preds, weights):
    """preds: (M, seg, C), weights: (M,) -> (seg, C)."""
    return _comb.ensemble_combine(preds, weights)


def ensemble_accumulate(partial, preds, weights, *,
                        out: Optional[torch.Tensor] = None):
    """Accumulate-into-partial combine: ``partial (seg, C)`` + ``preds (M,
    seg, C)`` weighted by ``weights (M,)`` -> (seg, C).  ``partial`` is cast
    to ``preds.dtype`` first, as in the JAX wrapper.  ``out`` may be
    ``partial`` (in-place accumulate)."""
    return _comb.ensemble_combine(preds, weights, partial.to(preds.dtype),
                                  out=out)


def ensemble_accumulate_quant(partial, q, scales, weights, *,
                              out: Optional[torch.Tensor] = None):
    """Fused dequant-weight-accumulate: ``partial (seg, C) f32`` + Σ_m
    ``w_m · (q_m · s_m)`` with ``q (M, seg, C)`` int8/fp8 and per-row
    ``scales (M, seg) f32`` -> (seg, C) f32.  ``out`` may be ``partial``."""
    return _comb.ensemble_combine_quant(partial.float(), q, scales.float(),
                                        weights, out=out)


def kernel_launches() -> Dict[str, int]:
    """Launches of each Hopper kernel since the last :func:`reset_counts`."""
    return {**_fa.launches.snapshot(), **_comb.launches.snapshot()}


def plain_calls() -> Dict[str, int]:
    """Calls of each plain version since the last :func:`reset_counts`."""
    return ref.calls.snapshot()


def reset_counts() -> None:
    _fa.launches.reset()
    _comb.launches.reset()
    ref.calls.reset()
