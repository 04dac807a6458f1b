"""Wrapper of the Hopper SSD scan kernel (``csrc/ssd_scan.cu``).

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
``ref.py``; there is no other path.  Nothing is padded: the kernel masks the
ragged last chunk itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Counter, _build, ref

launches = Counter("ssd_scan")

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check(x, dt, A, bmat, cmat, chunk):
    if x.dim() != 4:
        raise ValueError("ssd_scan: x must be (B, S, H, P)")
    b, s, h, _ = x.shape
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or bmat.dim() != 3 or tuple(bmat.shape[:2]) != (b, s)
            or cmat.shape != bmat.shape):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)} does not match dt "
            f"{tuple(dt.shape)} / A {tuple(A.shape)} / B {tuple(bmat.shape)}"
            f" / C {tuple(cmat.shape)}")
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk {chunk} must be positive")
    if any(t.dtype != torch.float32 for t in (x, dt, A, bmat, cmat)):
        raise TypeError("ssd_scan: the kernel takes f32 inputs only")
    if len({t.device for t in (x, dt, A, bmat, cmat)}) != 1:
        raise ValueError("ssd_scan: inputs on different devices")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *,
             chunk: int = 64) -> torch.Tensor:
    """x: (B,S,H,P), dt: (B,S,H) post-softplus, A: (H,) negative,
    bmat/cmat: (B,S,N), all f32 -> y (B,S,H,P) f32."""
    _check(x, dt, A, bmat, cmat, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, A, bmat, cmat)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    b, s, h, p = x.shape
    n = bmat.shape[2]
    if p % 4 or n % 4 or chunk % 4:
        raise ValueError(f"ssd_scan: head dim {p}, state {n} and chunk "
                         f"{chunk} must be multiples of 4")
    y = torch.empty_like(x)
    fn = _build.function("repro_ssd_scan", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), y.data_ptr(), b, s, h, p, n, chunk, stream)
    _build.check(err, "ssd_scan")
    launches.add("ssd_scan")
    return y
