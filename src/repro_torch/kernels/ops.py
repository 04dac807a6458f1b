"""Public kernel entries, with the JAX package's signatures.

Dispatch is by the tensors' device: a CPU tensor goes to the plain version in
``ref.py``, a CUDA tensor to the Hopper kernel, which launches or raises.
Unlike the TPU wrappers nothing is padded: the kernels mask ragged edges
themselves.  :func:`dense` and :func:`grouped_dense` have no JAX counterpart
(the JAX package leaves its products to XLA): each routes by a rule on its
operands, :func:`dense` between the 3xTF32 GEMM kernel and the call site's
own einsum, :func:`grouped_dense` between the grouped kernel and its plain
version.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import Counter, ref
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import ensemble_combine as _comb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm_tf32x3 as _gemm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.parallel.collectives import einsum, is_dtensor

library = Counter("dense")


def pow2_clamp(n: int, lo: int, hi: int) -> int:
    """Next power of two >= n, clamped to [lo, hi] (block-size selection)."""
    return min(hi, max(lo, 1 << max(n - 1, 1).bit_length()))


def _q_scale(q, scale: Optional[float]) -> float:
    """The softmax scale (default 1/sqrt(hd)) rounded to q's dtype, as the
    JAX wrapper's weakly-typed ``q * hd**-0.5`` rounds it."""
    s = q.shape[3] ** -0.5 if scale is None else scale
    return float(torch.tensor(s, dtype=q.dtype))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd); softmax scale
    ``scale``, default 1/sqrt(hd).

    q is scaled before the kernel in its own dtype, with the scale itself
    rounded to that dtype first, exactly as the JAX wrapper's weakly-typed
    ``q * hd**-0.5`` does (in bf16 this rounds q, and parity depends on it)."""
    return _fa.flash_attention((q * _q_scale(q, scale)).contiguous(),
                               k.contiguous(), v.contiguous(), causal=causal,
                               window=window)


def decode_attention(q, k, v, valid, *, scale: Optional[float] = None):
    """q: (B,1,H,hd), k/v: (B,L,KV,hd), valid: (L,) bool -> (B,1,H,hd);
    softmax scale ``scale``, default 1/sqrt(hd).  q is scaled in its own
    dtype as in :func:`flash_attention`; neither L nor hd is padded."""
    return _dec.decode_attention((q * _q_scale(q, scale)).contiguous(),
                                 k.contiguous(), v.contiguous(),
                                 valid.bool().contiguous())


def ssd_scan(x, dt, A, bmat, cmat, *, chunk: int = 64):
    """x: (B,S,H,P), dt: (B,S,H), A: (H,), bmat/cmat: (B,S,N) -> (B,S,H,P).
    No padding: the kernel masks a ragged last chunk itself."""
    return _ssd.ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                         bmat.contiguous(), cmat.contiguous(), chunk=chunk)


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


def _product(eq: str, ndim: int) -> bool:
    """``eq`` is '<batch>k,kn-><batch>n' for an x of ``ndim`` dims: x's last
    dim contracted with w's first, every other index of x kept in order."""
    ins, _, out = eq.replace(" ", "").partition("->")
    a, _, b = ins.partition(",")
    return (len(a) == ndim and len(b) == 2 and a[-1] == b[0]
            and len(set(a + b[1])) == ndim + 1 and out == a[:-1] + b[1])


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def _kernel_operands(x, w, use_kernel: bool) -> bool:
    """``use_kernel``, and x and w plain CUDA f32 tensors on one card (no
    DTensor), neither tracked by autograd, contiguous and 16-byte
    aligned: what the 3xTF32 GEMM kernels read."""
    if not use_kernel or is_dtensor(x) or is_dtensor(w):
        return False
    if not _on_card(x) or w.device != x.device:
        return False
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        return False
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return False
    return x.is_contiguous() and w.is_contiguous() and \
        not x.data_ptr() % 16 and not w.data_ptr() % 16


def dense_takes_kernel(x, w, eq: str, use_kernel: bool) -> bool:
    """Whether :func:`dense` runs ``einsum(eq, x, w)`` on the 3xTF32 GEMM
    kernel: :func:`_kernel_operands`; ``eq`` a product of x's last dim by
    ``w (K, N)``; and the shape rule ``gemm_tf32x3.takes`` (M = the rows
    of x at least its threshold, K and N multiples of 4)."""
    if not _kernel_operands(x, w, use_kernel):
        return False
    if w.dim() != 2 or not _product(eq, x.dim()):
        return False
    k, n = w.shape
    return _gemm.takes(x.numel() // max(k, 1), k, n)


def dense(x, w, eq: str, *, use_kernel: bool = False):
    """``einsum(eq, x, w)``, a product of ``x (..., K)`` by ``w (K, N)``
    (e.g. "bsd,de->bse").  Where :func:`dense_takes_kernel` holds, the
    3xTF32 GEMM kernel computes it at f32 accuracy; any other call is the
    call site's einsum exactly as it was (``parallel.collectives.einsum``,
    plain or DTensor), counted in :func:`library_calls`.  The route is
    chosen from the operands before any launch: nothing falls back."""
    if dense_takes_kernel(x, w, eq, use_kernel):
        k, n = w.shape
        return _gemm.gemm_tf32x3(x.reshape(-1, k), w).view(
            *x.shape[:-1], n)
    library.add("dense")
    return einsum(eq, x, w)


def grouped_takes_kernel(x, w, use_kernel: bool) -> bool:
    """Whether :func:`grouped_dense` runs on the grouped 3xTF32 kernel:
    :func:`_kernel_operands`, x (R, K) and w (E, K, N), K and N multiples
    of 4."""
    if not _kernel_operands(x, w, use_kernel):
        return False
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        return False
    return w.shape[1] % 4 == 0 and w.shape[2] % 4 == 0


def grouped_dense(x, w, offsets, *, rows=None, out=None, scatter=None,
                  scale=None, use_kernel: bool = False):
    """Each expert's grouped rows through its own ``w[e]`` (``gemm_tf32x3.
    gemm_tf32x3_grouped`` says how rows, offsets, scatter and scale are
    read).  Where :func:`grouped_takes_kernel` holds, the grouped 3xTF32
    kernel computes it with no host wait; any other call, on the CPU or
    the card, is the plain version ``ref.gemm_tf32x3_grouped_ref``, whose
    host reads the offsets, counted in :func:`plain_calls`."""
    if grouped_takes_kernel(x, w, use_kernel):
        return _gemm.gemm_tf32x3_grouped(x, w, offsets, rows=rows, out=out,
                                         scatter=scatter, scale=scale)
    return ref.gemm_tf32x3_grouped_ref(x, w, offsets, rows, out, scatter,
                                       scale)


def kernel_launches() -> Dict[str, int]:
    """Launches of each Hopper kernel since the last :func:`reset_counts`."""
    return {**_fa.launches.snapshot(), **_dec.launches.snapshot(),
            **_comb.launches.snapshot(), **_ssd.launches.snapshot(),
            **_gemm.launches.snapshot()}


def library_calls() -> Dict[str, int]:
    """Calls of :func:`dense` left to the call site's einsum since the last
    :func:`reset_counts`."""
    return library.snapshot()


def plain_calls() -> Dict[str, int]:
    """Calls of each plain version since the last :func:`reset_counts`."""
    return ref.calls.snapshot()


def reset_counts() -> None:
    _fa.launches.reset()
    _dec.launches.reset()
    _comb.launches.reset()
    _ssd.launches.reset()
    _gemm.launches.reset()
    library.reset()
    ref.calls.reset()
