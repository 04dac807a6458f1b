"""Wrapper of the Hopper SSD scan kernel (``csrc/ssd_scan.cu``).

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
``ref.py``; there is no other path.  Nothing is padded: the kernel masks the
ragged last chunk itself.  One launch is one call of the C entry.  At a
state of 32 or more that runs a pass that forms the scores C·Bᵀ and the
cumulative sums of dt·A once per (batch row, chunk) into a scratch, then
the scan on the tensor cores; below, the scan on the CUDA cores alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import Counter, _build, ref

launches = Counter("ssd_scan")

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_SMEM = 232448          # bytes of shared memory a block may take (227 KB)
MAX_WARPS = 8              # warps a block, a pair for each 16 head dims
MAX_STATE = 256            # N: the state strip of a warp lives in registers


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad(x: int, r: int, m: int) -> int:
    """The least y >= x with y = r (mod m)."""
    return x + (r - x) % m


@functools.lru_cache(maxsize=None)
def plan(p: int, n: int, chunk: int) -> dict:
    """The kernels' launch and shared-memory layout at head dim ``p``,
    state ``n`` and ``chunk`` (``make_plan`` in the source, line for line):
    the route (tensor cores for a state of 32 or more, else the CUDA cores),
    warps and blocks per head, stages of the cp.async ring (2, or 1 when
    two do not fit, or 0 when one does not; the CUDA-core route loads one
    set of tiles) and the bytes of the scan and of the scores pass."""
    lr, n8 = _up(chunk, 8), _up(n, 8)
    if n < 32:
        smem = 4 * (2 * chunk * (n + 4) + chunk * (p + 4) +
                    chunk * (chunk + 4) + n * (p + 4) + 4 * chunk)
        return {"route": "cuda_cores", "warps": 8, "groups": 1,
                "stages": int(smem <= MAX_SMEM), "smem": smem,
                "scores_smem": 0}
    pairs = min(MAX_WARPS // 2, -(-p // 16))
    warps, pb = 2 * pairs, 16 * pairs
    # x, B, C and S rows, then dt and cs
    stage = lr * (_pad(pb, 8, 16) + 2 * _pad(n8, 8, 16) + _pad(lr, 4, 8) + 2)
    cs = warps * 512           # the partials a warp hands its pair
    stages = (2 if 4 * (2 * stage + cs) <= MAX_SMEM else
              1 if 4 * (stage + cs) <= MAX_SMEM else 0)
    return {"route": "tensor_cores", "warps": warps, "groups": -(-p // pb),
            "stages": stages, "smem": 4 * (max(stages, 1) * stage + cs),
            "scores_smem": 4 * (_up(chunk, 16) + lr) * _pad(n8, 4, 32)}


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
    pl = plan(p, n, chunk)
    if n > MAX_STATE or not pl["stages"] or pl["scores_smem"] > MAX_SMEM:
        raise ValueError(f"ssd_scan: state {n} and chunk {chunk} take more "
                         f"than the {MAX_SMEM} bytes of shared memory a "
                         f"block may have, or the state is over "
                         f"{MAX_STATE}")
    y = torch.empty_like(x)
    # the first pass's scratch (tensor-core route): the scores C·Bᵀ and the
    # cumulative sums of dt·A of every chunk, held until the launch is
    # enqueued (freed earlier, another thread could be handed it first)
    scores = (torch.empty(b * -(-s // chunk) * chunk * (chunk + h),
                          dtype=torch.float32, device=x.device)
              if pl["route"] == "tensor_cores" else None)
    fn = _build.function("repro_ssd_scan", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(),
                 None if scores is None else scores.data_ptr(),
                 y.data_ptr(), b, s, h, p, n, chunk, stream)
    _build.check(err, "ssd_scan")
    launches.add("ssd_scan")
    return y
