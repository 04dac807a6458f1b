"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
``ref.py``; there is no other path.  q arrives already scaled by hd^-0.5
(``ops.flash_attention`` does that in q's dtype, as the JAX wrapper does).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Counter, _build, ref

launches = Counter("flash_attention")

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, hd)")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} heads not a multiple of {kv}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} not in (0, 256]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes f32 or bf16")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,hd) pre-scaled, k/v: (B,S,KV,hd) -> (B,S,H,hd) in q's
    dtype; head h reads kv head h // (H/KV)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=1.0)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    fn = _build.function("repro_flash_attention", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, h, k.shape[2], hd, int(causal), int(window),
                 int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_attention")
    launches.add("flash_attention")
    return out
