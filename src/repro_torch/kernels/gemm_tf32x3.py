"""Wrappers of the Hopper 3xTF32 GEMMs (``csrc/gemm_tf32x3.cu`` and its
grouped sibling ``csrc/gemm_tf32x3_grouped.cu``).

``out (M, N) = x (M, K) @ w (K, N)`` in f32, on the tensor cores at f32
accuracy; the grouped entry runs each expert's rows through its own
``w[e]``.  A CUDA tensor goes to the kernel, a CPU tensor to the plain
version in ``ref.py``; there is no other path.  Which products come here at
all is ``ops.dense``'s rule, on what it can observe of its operands
(:func:`takes` is its shape part): three tensor-core passes pay only where
a product is large enough, and the kernel reads 16-byte rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Counter, _build, ref, refuse_grad

launches = Counter("gemm_tf32x3", "gemm_tf32x3_grouped")

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# The least M (rows of x) that ``ops.dense`` sends here: the larger of the
# two served widths' crossovers, the least M from which the kernel beats
# cuBLAS f32 (chip_smoke.py's kernel:gemm_tf32x3 ``crossover`` on an H100:
# 128 for in_proj's 2048 x 8512, 768 for out_proj's 4096 x 2048; PERF.md
# §6).  Below it out_proj's grid is under one wave of blocks, each walking
# all of K.
MIN_ROWS = 768


def takes(m: int, k: int, n: int) -> bool:
    """Whether ``ops.dense`` runs an (m, k) x (k, n) product here: M at
    least :data:`MIN_ROWS`, K and N multiples of 4 (16-byte rows)."""
    return m >= MIN_ROWS and k > 0 and n > 0 and k % 4 == 0 and n % 4 == 0


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_tf32x3: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (M, K) and (K, N)")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("gemm_tf32x3: the kernel takes f32 inputs only")
    if x.device != w.device:
        raise ValueError("gemm_tf32x3: x and w on different devices")


def gemm_tf32x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N), f32 -> (M, N) f32."""
    refuse_grad("gemm_tf32x3", x, w)
    _check(x, w)
    if x.device.type == "cpu":
        return ref.gemm_tf32x3_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gemm_tf32x3: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm_tf32x3: inputs must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if k % 4 or n % 4 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"gemm_tf32x3: K {k} and N {n} must be multiples of "
                         f"4 and x, w 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("repro_gemm_tf32x3", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, stream)
    _build.check(err, "gemm_tf32x3")
    launches.add("gemm_tf32x3")
    return out


_GROUPED_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _index(t, n: int, name: str):
    """``t`` as a contiguous int32 vector of ``n`` entries on the card."""
    if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.int32:
        raise ValueError(f"gemm_tf32x3_grouped: {name} must be ({n},) int32")
    return t.contiguous()


def gemm_tf32x3_grouped(x, w, offsets, *, rows=None, out=None, scatter=None,
                        scale=None) -> torch.Tensor:
    """Grouped products at f32 accuracy: ``x`` (R, K), ``w`` (E, K, N),
    ``offsets`` (E+1,) int32 in device memory.  Grouped row i of expert e
    (offsets[e] <= i < offsets[e+1]) is ``x[rows[i]] @ w[e]``, or ``x[i]
    @ w[e]`` where ``rows`` is None.  Without ``scatter`` returns the
    grouped rows (A, N), A the length of ``rows`` (or R), rows past
    offsets[E] unspecified; with ``scatter`` (A,) and ``scale`` (A,) adds
    ``scale[i]`` times row i into ``out[scatter[i]]`` (atomically, in no
    fixed order) and returns ``out``.  The host reads nothing of the
    offsets: the kernel's persistent blocks walk the tiles they give."""
    refuse_grad("gemm_tf32x3_grouped", x, w, out)
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"gemm_tf32x3_grouped: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (R, K) and (E, K, N)")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("gemm_tf32x3_grouped: the kernel takes f32 inputs "
                        "only")
    if (scatter is None) != (scale is None) or \
            (scatter is None) != (out is None):
        raise ValueError("gemm_tf32x3_grouped: out, scatter and scale go "
                         "together")
    e, k, n = w.shape
    a = x.shape[0] if rows is None else rows.shape[0]
    if x.device.type == "cpu":
        return ref.gemm_tf32x3_grouped_ref(x, w, offsets, rows, out, scatter,
                                           scale)
    if x.device.type != "cuda":
        raise ValueError(f"gemm_tf32x3_grouped: unsupported device "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm_tf32x3_grouped: inputs must be contiguous")
    if k % 4 or n % 4 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"gemm_tf32x3_grouped: K {k} and N {n} must be "
                         f"multiples of 4 and x, w 16-byte aligned")
    offsets = _index(offsets, e + 1, "offsets")
    if rows is not None:
        rows = _index(rows, a, "rows")
    if scatter is None:
        out = torch.empty((a, n), dtype=torch.float32, device=x.device)
    else:
        scatter = _index(scatter, a, "scatter")
        if scale.shape != (a,) or scale.dtype != torch.float32 or \
                out.dtype != torch.float32 or out.dim() != 2 or \
                out.shape[1] != n or not out.is_contiguous():
            raise ValueError("gemm_tf32x3_grouped: scale must be (A,) f32 "
                             "and out (T, N) f32, contiguous")
        scale = scale.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.function("repro_gemm_tf32x3_grouped", _GROUPED_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 offsets.data_ptr(), ptr(rows), ptr(scatter), ptr(scale),
                 e, a, k, n, stream)
    _build.check(err, "gemm_tf32x3_grouped")
    launches.add("gemm_tf32x3_grouped")
    return out
