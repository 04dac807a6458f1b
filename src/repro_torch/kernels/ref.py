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

calls = Counter("flash_attention", "ensemble_combine", "ensemble_accumulate",
                "ensemble_accumulate_quant")


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
