"""GQA self-attention (qk-norm, RoPE, sliding window).

Three execution paths, as in the JAX package:
  * ``use_kernel``: the flash-attention kernel through ``kernels.ops`` (the
    Hopper kernel for CUDA tensors, its plain version for CPU tensors);
  * sequences up to ``_DENSE_MAX``: the plain masked einsum;
  * longer sequences: an online-softmax loop over KV chunks, O(S·chunk)
    live memory.
Cross-attention and cached decode attention are not ported yet (ROADMAP
Queue 1 items 13 and 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -1e30
_CHUNK = 512          # KV chunk for the online-softmax loop
_DENSE_MAX = 2048     # sequences up to this use the plain masked einsum


def project_qkv(cfg: ModelConfig, p, x):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // kv, dim=2)


def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(Sq,Sk) additive bias from position vectors."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def dense_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain masked attention.  q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd)."""
    h = q.shape[2]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    scale = scale or q.shape[-1] ** -0.5
    logits = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    logits = logits + _mask_bias(q_pos, k_pos, causal, window)[None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
                      chunk: int = _CHUNK) -> torch.Tensor:
    """Online-softmax attention looping over KV chunks; O(Sq*chunk) memory."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sk % chunk:                                   # pad kv to chunk multiple
        pad = chunk - sk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=2 ** 30)
    nk = k.shape[1] // chunk
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    qf = q.float() * (hd ** -0.5)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    for i in range(nk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = torch.einsum("bqhk,bshk->bhqs", qf, k[:, sl].float())
        logits = logits + _mask_bias(q_pos, k_pos[sl], causal, window)[None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + \
            torch.einsum("bhqs,bshk->bqhk", p, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def self_attention(cfg: ModelConfig, p, x, positions, *, window: int = 0,
                   use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence causal attention for serving/prefill.  x: (B,S,D)."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    elif s <= _DENSE_MAX:
        out = dense_attention(q, k, v, positions, positions, causal=True,
                              window=window)
    else:
        out = chunked_attention(q, k, v, positions, positions, causal=True,
                                window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
