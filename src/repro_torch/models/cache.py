"""Decode state: KV ring buffers and SSM states (PyTorch port).

The layout is the JAX package's: ``cache["layers"]`` is a list with one
entry per position of the pattern unit, and every tensor carries a leading
``repeats`` dim.  ``decode_step`` writes the new slot and the new SSM state
into these tensors in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ATTN, CROSS, HYBRID, SSM, SWA, ModelConfig


def layer_cache_struct(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                       dtype=torch.float32, *, quantized: bool = False
                       ) -> Dict[str, Any]:
    """(shape, dtype) of each tensor of one layer's cache, without the
    leading repeats dim.  ATTN layers hold ``max_len`` slots, SWA and HYBRID
    layers a ring of ``min(max_len, sliding_window)``; an int8 cache adds
    per-slot, per-head f32 scales."""
    out: Dict[str, Any] = {}
    kv, hd = cfg.num_kv_heads, cfg.hd

    def kv_entry(L):
        if quantized:
            out["k"] = ((batch, L, kv, hd), torch.int8)
            out["v"] = ((batch, L, kv, hd), torch.int8)
            out["k_scale"] = ((batch, L, kv, 1), torch.float32)
            out["v_scale"] = ((batch, L, kv, 1), torch.float32)
        else:
            out["k"] = ((batch, L, kv, hd), dtype)
            out["v"] = ((batch, L, kv, hd), dtype)

    if kind in (ATTN, SWA, HYBRID):
        kv_entry(max_len if kind == ATTN else min(max_len, cfg.sliding_window))
    if kind == CROSS:
        kv_entry(cfg.frontend_tokens)
    if kind in (SSM, HYBRID):
        s = cfg.ssm
        out["h"] = ((batch, cfg.ssm_heads, s.head_dim, s.d_state), torch.float32)
        out["conv"] = ((batch, s.d_conv - 1, cfg.d_inner + 2 * s.d_state), dtype)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               *, quantized: bool = False, device="cuda"):
    """Zero-initialised cache tree on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_cache: no CUDA device is available "
                           "(pass device='cpu' to build on the host)")
    layers = []
    for kind in cfg.pattern:
        layers.append({
            name: torch.zeros((cfg.repeats,) + shape, dtype=dt, device=device)
            for name, (shape, dt) in layer_cache_struct(
                cfg, kind, batch, max_len, dtype, quantized=quantized).items()})
    return {"layers": layers}


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.float32, *, quantized: bool = False,
                 device="meta"):
    """The cache tree as empty tensors of its shapes and dtypes (meta, so
    nothing is allocated, unless made under ``FakeTensorMode`` on another
    device): the JAX package's ``ShapeDtypeStruct`` tree."""
    return {"layers": [
        {name: torch.empty((cfg.repeats,) + shape, dtype=dt, device=device)
         for name, (shape, dt) in layer_cache_struct(
             cfg, kind, batch, max_len, dtype, quantized=quantized).items()}
        for kind in cfg.pattern]}
