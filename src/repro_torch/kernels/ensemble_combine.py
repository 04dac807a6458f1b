"""Wrappers of the Hopper combine kernels (``csrc/ensemble_combine.cu``).

``ensemble_combine``: ``Y = [partial +] Σ_m w_m·P_m`` over ``P (M, seg, C)``
f32 (the fresh form without ``partial``, the accumulate form with it).
``ensemble_combine_quant``: ``partial + Σ_m w_m·(q_m·s_m)`` with ``q`` int8 or
fp8-e4m3 and per-row scales ``s (M, seg)`` f32.  Both take ``out=``, which
may be ``partial`` itself: the kernels read each element before they write
it, so the device combiner accumulates in place.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
``ref.py``; there is no other path.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import Counter, _build, ref, refuse_grad

launches = Counter("ensemble_combine", "ensemble_combine_quant")

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_void_p]
_QUANT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _device_of(*ts) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"ensemble_combine: tensors on {t.device} and "
                             f"{dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ensemble_combine: unsupported device {dev}")
    return dev


def _check_f32(name: str, *ts):
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _out(out, seg, c, like):
    if out is None:
        return torch.empty((seg, c), dtype=torch.float32, device=like.device)
    if out.shape != (seg, c) or out.dtype != torch.float32 or \
            not out.is_contiguous() or out.device != like.device:
        raise ValueError(f"ensemble_combine: bad out {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    return out


def ensemble_combine(preds: torch.Tensor, weights: torch.Tensor,
                     partial: Optional[torch.Tensor] = None, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """preds (M, seg, C), weights (M,), optional partial (seg, C), all f32
    -> (seg, C) f32."""
    refuse_grad("ensemble_combine", preds, weights, partial)
    if preds.dim() != 3 or weights.shape != (preds.shape[0],):
        raise ValueError(f"ensemble_combine: preds {tuple(preds.shape)}, "
                         f"weights {tuple(weights.shape)}")
    m, seg, c = preds.shape
    if partial is not None and partial.shape != (seg, c):
        raise ValueError(f"ensemble_combine: partial {tuple(partial.shape)} "
                         f"!= {(seg, c)}")
    operands = (preds, weights) + ((partial,) if partial is not None else ())
    dev = _device_of(*operands)
    if dev.type == "cpu":
        y = ref.ensemble_combine_ref(preds, weights) if partial is None \
            else ref.ensemble_accumulate_ref(partial, preds, weights)
        return y if out is None else out.copy_(y)
    _check_f32("ensemble_combine", *operands)
    y = _out(out, seg, c, preds)
    fn = _build.function("repro_ensemble_combine", _ARGS)
    with torch.cuda.device(dev):
        err = fn(preds.data_ptr(), weights.data_ptr(),
                 partial.data_ptr() if partial is not None else None,
                 y.data_ptr(), m, seg * c,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ensemble_combine")
    launches.add("ensemble_combine")
    return y


_QDTYPES = {torch.int8: 0}
if hasattr(torch, "float8_e4m3fn"):
    _QDTYPES[torch.float8_e4m3fn] = 1


def ensemble_combine_quant(partial: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor, weights: torch.Tensor, *,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """partial (seg, C) f32, q (M, seg, C) int8/e4m3, scales (M, seg) f32,
    weights (M,) f32 -> (seg, C) f32."""
    refuse_grad("ensemble_combine_quant", partial, q, scales, weights)
    if q.dim() != 3:
        raise ValueError(f"ensemble_combine_quant: q {tuple(q.shape)}")
    m, seg, c = q.shape
    if partial.shape != (seg, c) or scales.shape != (m, seg) or \
            weights.shape != (m,):
        raise ValueError(
            f"ensemble_combine_quant: partial {tuple(partial.shape)}, q "
            f"{tuple(q.shape)}, scales {tuple(scales.shape)}, weights "
            f"{tuple(weights.shape)}")
    if q.dtype not in _QDTYPES:
        raise TypeError(f"ensemble_combine_quant: q dtype {q.dtype}; the "
                        f"kernel takes int8 or float8_e4m3fn")
    dev = _device_of(partial, q, scales, weights)
    if dev.type == "cpu":
        y = ref.ensemble_accumulate_quant_ref(partial, q, scales, weights)
        return y if out is None else out.copy_(y)
    _check_f32("ensemble_combine_quant", partial, scales, weights)
    if not q.is_contiguous():
        raise ValueError("ensemble_combine_quant: q must be contiguous")
    y = _out(out, seg, c, partial)
    fn = _build.function("repro_ensemble_combine_quant", _QUANT_ARGS)
    with torch.cuda.device(dev):
        err = fn(partial.data_ptr(), q.data_ptr(), scales.data_ptr(),
                 weights.data_ptr(), y.data_ptr(), m, seg, c,
                 _QDTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ensemble_combine_quant")
    launches.add("ensemble_combine_quant")
    return y
