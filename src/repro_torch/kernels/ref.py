"""Plain PyTorch versions of the Hopper kernels.

``ops.py`` runs them for tensors on the CPU; on the card they are what each
kernel is held against.  ``calls`` counts every call, so a run on the card
can show that its main path never took them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import Counter

NEG_INF = -1e30

calls = Counter("flash_attention", "decode_attention", "ensemble_combine",
                "ensemble_accumulate", "ensemble_accumulate_quant", "ssd_scan",
                "gemm_tf32x3", "gemm_tf32x3_grouped")


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd), computed in f32 and
    returned in q's dtype.  ``scale`` defaults to hd^-0.5; ``ops`` passes
    q already scaled and ``scale=1``, as the kernel receives it."""
    calls.add("flash_attention")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    scale = hd ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    logits = torch.where(ok[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, valid, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,hd), k/v: (B,L,KV,hd), valid: (L,) bool -> (B,1,H,hd),
    computed in f32 and returned in q's dtype: the decode path's masked
    softmax, ``models.attention.masked_decode``.  ``scale`` defaults to
    hd^-0.5; ``ops`` passes q already scaled and ``scale=1``."""
    calls.add("decode_attention")
    from repro_torch.models.attention import masked_decode
    return masked_decode(q, k, v, valid, scale=scale)


def ssd_scan_ref(x, dt, A, bmat, cmat, *, chunk: int = 64) -> torch.Tensor:
    """The chunked dual form of the Mamba2 scan, ``models.ssm.ssd_chunked``.
    x: (B,S,H,P) f32, dt: (B,S,H) post-softplus, A: (H,) negative,
    bmat/cmat: (B,S,N) -> y (B,S,H,P).  A ragged S is zero-padded to whole
    chunks and cut back."""
    calls.add("ssd_scan")
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, bmat, cmat, chunk)


def ssd_scan_sequential_ref(x, dt, A, bmat, cmat) -> torch.Tensor:
    """The step-by-step recurrence, one position at a time (the ground
    truth both chunked forms are held to)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A[None, :])
        hstate = hstate * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], bmat[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cmat[:, t], hstate))
    return torch.stack(ys, dim=1)


def ensemble_combine_ref(preds, weights) -> torch.Tensor:
    """preds: (M, seg, C), weights: (M,) -> (seg, C) in preds' dtype."""
    calls.add("ensemble_combine")
    return torch.einsum("m,msc->sc", weights.float(),
                        preds.float()).to(preds.dtype)


def ensemble_accumulate_ref(partial, preds, weights) -> torch.Tensor:
    """partial (seg, C) + the weighted member sum, in preds' dtype."""
    calls.add("ensemble_accumulate")
    acc = torch.einsum("m,msc->sc", weights.float(), preds.float())
    return (partial.float() + acc).to(preds.dtype)


def ensemble_accumulate_quant_ref(partial, q, scales, weights) -> torch.Tensor:
    """partial (seg, C) f32 + Σ_m w_m·(q_m·s_m) with q (M, seg, C) int8/fp8
    and per-row scales (M, seg) f32 -> (seg, C) f32."""
    calls.add("ensemble_accumulate_quant")
    acc = partial.float().clone()
    for m in range(q.shape[0]):
        acc += (q[m].float() * scales[m].float()[:, None]) * weights[m].float()
    return acc


def gemm_tf32x3_ref(x, w) -> torch.Tensor:
    """x (M, K) @ w (K, N) in f32 -> (M, N)."""
    calls.add("gemm_tf32x3")
    return x @ w


def gemm_tf32x3_grouped_ref(x, w, offsets, rows=None, out=None, scatter=None,
                            scale=None) -> torch.Tensor:
    """The grouped products in f32, expert by expert (the host reads the
    offsets).  ``x`` (R, K), ``w`` (E, K, N), ``offsets`` (E+1,): grouped
    row i of expert e (offsets[e] <= i < offsets[e+1]) is ``x[rows[i]] @
    w[e]`` (``x[i]`` where ``rows`` is None).  Without ``scatter``, returns
    them as (A, N), A the rows of ``rows`` (or of ``x``), zeros past
    offsets[E]; with it, adds ``scale[i]`` times row i into
    ``out[scatter[i]]`` and returns ``out``."""
    calls.add("gemm_tf32x3_grouped")
    offs = [int(o) for o in offsets.tolist()]
    n_rows = x.shape[0] if rows is None else rows.shape[0]
    y = x.new_zeros((n_rows, w.shape[-1])) if scatter is None else out
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi <= lo:
            continue
        xe = x[lo:hi] if rows is None else x[rows[lo:hi].long()]
        ye = xe @ w[e]
        if scatter is None:
            y[lo:hi] = ye
        else:
            y.index_add_(0, scatter[lo:hi].long(), scale[lo:hi, None] * ye)
    return y
