"""Wrapper of the Hopper SSD scan kernel (``csrc/ssd_scan.cu``).

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
``ref.py``; there is no other path.  The sequence is not padded: the kernel
masks the ragged last chunk itself.  One launch is one call of the C entry.
At a state of 32 to 256 that runs a pass that forms the scores C·Bᵀ and the
cumulative sums of dt·A once per (batch row, chunk) into a scratch, then the
scan on the tensor cores; at other states, the scan on the CUDA cores alone.
It runs at the largest chunk whose layout fits 227 KB of shared memory,
and a head dim or state that is not a multiple of 4 is padded; so the
kernel takes every shape the JAX entry does up to a CUDA-core state of
:func:`max_core_state` (760 at a head dim of 64; see :func:`plan`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import Counter, _build, ref, refuse_grad

launches = Counter("ssd_scan")

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_SMEM = 232448          # bytes of shared memory a block may take (227 KB)
MAX_WARPS = 8              # warps a block, a pair for each 16 head dims
MAX_STATE = 256            # N of the tensor-core route: a warp's strip of
                           # the state lives in its registers


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad(x: int, r: int, m: int) -> int:
    """The least y >= x with y = r (mod m)."""
    return x + (r - x) % m


def _core_smem(p: int, n: int, lc: int) -> int:
    """Bytes of the CUDA-core route's tiles and state."""
    return 4 * (2 * lc * (n + 4) + lc * (p + 4) + lc * (lc + 4) +
                n * (p + 4) + 4 * lc)


def max_core_state(p: int) -> int:
    """The largest state (a multiple of 4) the CUDA-core route takes at head
    dim ``p``: its P x N state and one set of tiles fit 227 KB at chunk 4."""
    return (MAX_SMEM // 4 - 80 - 4 * (p + 4)) // (p + 12) // 4 * 4


def _layout(p: int, n: int, lc: int) -> dict:
    """``make_plan`` in the source, line for line, at the kernel's chunk
    ``lc``."""
    if not 32 <= n <= MAX_STATE:
        smem = _core_smem(p, n, lc)
        return {"route": "cuda_cores", "warps": 8, "groups": 1,
                "stages": int(smem <= MAX_SMEM), "smem": smem,
                "scores_smem": 0}
    lr, n8 = _up(lc, 8), _up(n, 8)
    pairs = min(MAX_WARPS // 2, -(-p // 16))
    warps, pb = 2 * pairs, 16 * pairs
    # x, B, C and S rows, then dt and cs
    stage = lr * (_pad(pb, 8, 16) + 2 * _pad(n8, 8, 16) + _pad(lr, 4, 8) + 2)
    cs = warps * 512           # the partials a warp hands its pair
    stages = (2 if 4 * (2 * stage + cs) <= MAX_SMEM else
              1 if 4 * (stage + cs) <= MAX_SMEM else 0)
    return {"route": "tensor_cores", "warps": warps,
            "groups": -(-p // pb), "stages": stages,
            "smem": 4 * (max(stages, 1) * stage + cs),
            "scores_smem": 4 * (_up(lc, 16) + lr) * _pad(n8, 4, 32)}


def _fits(pl: dict) -> bool:
    return pl["stages"] > 0 and pl["scores_smem"] <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def plan(p: int, n: int, chunk: int) -> dict:
    """The kernels' launch and shared-memory layout at head dim ``p`` and
    state ``n`` (both multiples of 4) for a caller's ``chunk``: the route
    (tensor cores for 32 <= n <= 256, else the CUDA cores), warps and blocks
    ``groups`` a head, stages of the cp.async ring (2, or 1 when two do not
    fit; the CUDA-core route loads one set of tiles), the bytes of the scan
    and of the scores pass, and ``chunk``, the kernel's own chunk: the
    caller's, rounded down to a multiple of 4, or where that layout does not
    fit 227 KB, the largest that fits.  The result does not depend on the
    chunk beyond rounding, and the kernel masks a ragged last chunk.  Raises
    ``ValueError`` where no chunk fits: a CUDA-core state over
    :func:`max_core_state`."""
    for lc in range(max(4, chunk // 4 * 4), 0, -4):
        pl = _layout(p, n, lc)
        if _fits(pl):
            return {**pl, "chunk": lc}
    raise ValueError(f"ssd_scan: at head dim {p} the kernel takes a state of "
                     f"at most {max_core_state(p)}, not {n}: no layout fits "
                     f"the {MAX_SMEM} bytes of shared memory a block may "
                     f"have")


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
    refuse_grad("ssd_scan", x, dt, A, bmat, cmat)
    _check(x, dt, A, bmat, cmat, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, A, bmat, cmat)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    b, s, h, p = x.shape
    n = bmat.shape[2]
    # the kernel reads head dims and state in fours: a head dim or state
    # that is not a multiple of 4 is padded with zeros, which add nothing
    # to the scores or the state, and the padded head dims are cut off y
    p4, n4 = _up(p, 4), _up(n, 4)
    if p4 != p:
        x = torch.nn.functional.pad(x, (0, p4 - p))
    if n4 != n:
        bmat = torch.nn.functional.pad(bmat, (0, n4 - n))
        cmat = torch.nn.functional.pad(cmat, (0, n4 - n))
    pl = plan(p4, n4, chunk)
    lc = pl["chunk"]
    y = torch.empty_like(x)
    # the first pass's scratch (tensor-core route): the scores C·Bᵀ and the
    # cumulative sums of dt·A of every chunk, held until the launch is
    # enqueued (freed earlier, another thread could be handed it first)
    scores = (torch.empty(b * -(-s // lc) * lc * (lc + h),
                          dtype=torch.float32, device=x.device)
              if pl["route"] == "tensor_cores" else None)
    fn = _build.function("repro_ssd_scan", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(),
                 None if scores is None else scores.data_ptr(),
                 y.data_ptr(), b, s, h, p4, n4, lc, stream)
    _build.check(err, "ssd_scan")
    launches.add("ssd_scan")
    return y if p4 == p else y[..., :p].contiguous()
