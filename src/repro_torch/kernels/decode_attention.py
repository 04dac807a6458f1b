"""Wrapper of the Hopper flash-decoding kernel (``csrc/decode_attention.cu``).

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
``ref.py``; there is no other path.  q arrives already scaled by hd^-0.5
(``ops.decode_attention`` does that in q's dtype, as the JAX wrapper does).
One launch is one call of the C entry, which runs the split pass over the
cache and the pass that merges the splits.  The splits' partial results
share one scratch allocation.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import Counter, _build, ref, refuse_grad

launches = Counter("decode_attention")

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TILE = 32                  # cache slots per tile (kT in the source)
MAX_GROUP_DIMS = 2048      # query heads x hd one block holds (128 x kMaxR)


def _check(q, k, v, valid):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or q.shape[1] != 1:
        raise ValueError("decode_attention: q must be (B, 1, H, hd) and "
                         "k, v (B, L, KV, hd)")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)} / v {tuple(v.shape)}")
    L, kv = k.shape[1], k.shape[2]
    if L == 0 or tuple(valid.shape) != (L,):
        raise ValueError(f"decode_attention: valid {tuple(valid.shape)} is "
                         f"not ({L},), or the cache is empty")
    if kv == 0 or h % kv:
        raise ValueError(f"decode_attention: {h} heads not a multiple of {kv}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {hd} not in (0, 256]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes f32 or bf16")
    if valid.dtype != torch.bool:
        raise TypeError(f"decode_attention: valid is {valid.dtype}, not bool")
    if not (q.device == k.device == v.device == valid.device):
        raise ValueError("decode_attention: inputs on different devices")


def heads_per_block(h: int, kv: int, hd: int) -> int:
    """The group's query heads in as few blocks as fit."""
    return max(1, min(h // kv, MAX_GROUP_DIMS // hd))


@functools.lru_cache(maxsize=None)
def _resident(index: int, hd: int, gb: int, bf16: bool) -> tuple:
    """(SMs, split-kernel blocks that fit one SM) of device ``index``."""
    fn = _build.function("repro_decode_occupancy",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(hd, gb, int(bf16), ctypes.addressof(blocks))
    _build.check(err, "decode_attention")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, max(1, blocks.value)


@functools.lru_cache(maxsize=None)
def split_plan(b: int, L: int, h: int, kv: int, hd: int, sms: int,
               blocks_per_sm: int = 3):
    """(heads per block, tiles per split, splits): the cache's tiles dealt
    to as many splits as one wave of the grid holds, ``blocks_per_sm``
    blocks on each of ``sms`` SMs (the wrapper passes what fits an SM; a
    second, partial wave costs more on the card than longer splits).
    Split s takes tiles s, s + splits, s + 2·splits, ...
    (:func:`split_tiles`), at most ``tps``."""
    gb = heads_per_block(h, kv, hd)
    pairs = b * kv * -(-(h // kv) // gb)
    ntiles = -(-L // TILE)
    want = max(1, min(ntiles, blocks_per_sm * sms // pairs))
    tps = -(-ntiles // want)
    return gb, tps, -(-ntiles // tps)


def split_tiles(split: int, nsplit: int, ntiles: int):
    """The tiles that split ``split`` of ``nsplit`` walks, in order: the
    kernel's loop over its tiles (``decode_split_kernel``)."""
    return range(split, ntiles, nsplit)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q: (B,1,H,hd) pre-scaled, k/v: (B,L,KV,hd), valid: (L,) bool ->
    (B,1,H,hd) in q's dtype; head h reads kv head h // (H/KV)."""
    refuse_grad("decode_attention", q, k, v)
    _check(q, k, v, valid)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, scale=1.0)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("decode_attention: inputs must be contiguous")
    b, _, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    index = q.device.index
    sms, resident = _resident(index, hd, heads_per_block(h, kv, hd),
                              q.dtype == torch.bfloat16)
    gb, tps, nsplit = split_plan(b, L, h, kv, hd, sms, resident)
    # m, l and acc of every (batch, head, split): views of one allocation
    n = b * h * nsplit
    part = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
    ptr = part.data_ptr()
    out = torch.empty_like(q)
    fn = _build.function("repro_decode_attention", _ARGS)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), ptr,
            ptr + 4 * n, ptr + 8 * n, out.data_ptr(), b, L, h, kv, hd, gb,
            tps, nsplit, int(q.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:                  # the launch goes to the current device
        with torch.cuda.device(index):
            err = fn(*args, stream)
    _build.check(err, "decode_attention")
    launches.add("decode_attention")
    return out
