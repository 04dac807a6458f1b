"""GQA self-attention (qk-norm, RoPE, sliding window), cross-attention and
cached decode attention.

Three execution paths for the full sequence, as in the JAX package:
  * ``use_kernel``: the flash-attention kernel through ``kernels.ops`` (the
    Hopper kernel for CUDA tensors, its plain version for CPU tensors);
  * sequences up to ``_DENSE_MAX``: the plain masked einsum;
  * longer sequences: an online-softmax loop over KV chunks, O(S·chunk)
    live memory.
One token against a cache (:func:`decode_attention`) takes the
decode-attention kernel through ``kernels.ops`` when ``use_kernel`` and the
cache is not int8, else the plain masked softmax.  Cross-attention
(:func:`cross_attention`) attends to frontend embeddings with no mask and no
RoPE, by the plain einsum up to ``_DENSE_MAX`` positions and the chunked loop
above; the JAX package runs no kernel there either.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch import runtime_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.parallel.collectives import (contiguous_strides, einsum,
                                           flash_decode, is_dtensor, pad,
                                           settle)

NEG_INF = -1e30
_CHUNK = 512          # KV chunk for the online-softmax loop
_DENSE_MAX = 2048     # sequences up to this use the plain masked einsum


def project_qkv(cfg: ModelConfig, p, x, kv_src=None):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,Skv,KV,hd) projected from
    ``kv_src`` (default x)."""
    kv_src = x if kv_src is None else kv_src
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", kv_src, p["wk"])
    v = einsum("bsd,dhk->bshk", kv_src, p["wv"])
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
    logits = einsum("bqhk,bshk->bhqs", q, k).float() * scale
    logits = logits + _mask_bias(q_pos, k_pos, causal, window)[None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return einsum("bhqs,bshk->bqhk", probs, v)


def _carries(qf):
    """The online softmax's running max and sum (B,H,Sq) and accumulator
    (B,Sq,H,hd), f32.  For a DTensor ``qf`` each is made from this rank's
    part and placed as ``qf``'s batch, sequence and head dims are: a zeros
    of the global shape would be replicated whole on every rank."""
    b, sq, h, hd = qf.shape
    if not is_dtensor(qf):
        return (torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                           device=qf.device),
                torch.zeros((b, h, sq), dtype=torch.float32, device=qf.device),
                torch.zeros((b, sq, h, hd), dtype=torch.float32,
                            device=qf.device))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, local = qf.device_mesh, qf.to_local()
    lb, lsq, lh, _ = local.shape
    to_bhq = {0: 0, 1: 2, 2: 1}          # (B,Sq,H) dims -> (B,H,Sq) dims
    pl = [Shard(to_bhq[p.dim]) if isinstance(p, Shard) and p.dim in to_bhq
          else Replicate() for p in qf.placements]
    shape = torch.Size((b, h, sq))

    def carry(t):
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=contiguous_strides(shape))
    kw = dict(dtype=torch.float32, device=local.device)
    return (carry(torch.full((lb, lh, lsq), NEG_INF, **kw)),
            carry(torch.zeros((lb, lh, lsq), **kw)), torch.zeros_like(qf))


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
                      chunk: int = _CHUNK,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention looping over KV chunks; O(Sq*chunk) memory.
    ``scale`` defaults to hd^-0.5."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sk % chunk:                                   # pad kv to chunk multiple
        extra = chunk - sk % chunk
        k = pad(k, (0, 0, 0, 0, 0, extra))
        v = pad(v, (0, 0, 0, 0, 0, extra))
        k_pos = pad(k_pos, (0, extra), value=2 ** 30)
    nk = k.shape[1] // chunk
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    qf = q.float() * (hd ** -0.5 if scale is None else scale)
    m, l, acc = _carries(qf)
    for i in range(nk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = einsum("bqhk,bshk->bhqs", qf, k[:, sl].float())
        bias = _mask_bias(q_pos, k_pos[sl], causal, window)[None, None]
        # a DTensor chunk outside autograd takes the bias, the shift and the
        # exp in its own storage, as XLA fuses them: one rank's (B,H,Sq,
        # chunk) scores are a few GB where no mesh dim shards the heads
        in_place = is_dtensor(logits) and not logits.requires_grad
        logits = settle(logits).add_(bias) if in_place else logits + bias
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = logits.sub_(m_new[..., None]).exp_() if in_place else \
            torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + \
            einsum("bhqs,bshk->bqhk", p, v[:, sl].float())
        m = m_new
        del logits, p         # before the next chunk's scores are made
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def self_attention(cfg: ModelConfig, p, x, positions, *, window: int = 0,
                   use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence causal attention for serving/prefill.  x: (B,S,D)."""
    q, k, v = project_qkv(cfg, p, x)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    s, scale = x.shape[1], cfg.attn_scale
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   scale=scale)
    elif s <= _DENSE_MAX:
        out = dense_attention(q, k, v, positions, positions, causal=True,
                              window=window, scale=scale)
    else:
        out = chunked_attention(q, k, v, positions, positions, causal=True,
                                window=window, scale=scale)
    return einsum("bshk,hkd->bsd", out, p["wo"])


def cross_attention(cfg: ModelConfig, p, x, frontend) -> torch.Tensor:
    """x: (B,S,D) attends to frontend embeddings (B,F,fdim).  No mask, no
    RoPE."""
    q, k, v = project_qkv(cfg, p, x, kv_src=frontend)
    return einsum("bshk,hkd->bsd", attend_all(q, k, v), p["wo"])


def attend_all(q, k, v) -> torch.Tensor:
    """q (B,Sq,H,hd) against every key of k/v (B,Sk,KV,hd), no mask: the
    plain einsum up to ``_DENSE_MAX`` positions, the chunked loop above."""
    qp = torch.arange(q.shape[1], device=q.device)
    kp = torch.arange(k.shape[1], device=q.device)
    if max(q.shape[1], k.shape[1]) <= _DENSE_MAX:
        return dense_attention(q, k, v, qp, kp, causal=False)
    return chunked_attention(q, k, v, qp, kp, causal=False)


def masked_decode(q, k, v, valid, *, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """One query token against a cache, in f32: q (B,1,H,hd), k/v
    (B,L,KV,hd), valid (L,) bool -> (B,1,H,hd) in q's dtype.  The logits
    are scaled (default hd^-0.5) and invalid slots set to -1e30 before the
    softmax.  The plain decode path and the kernel's plain version."""
    h = q.shape[2]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return einsum("bhqs,bshk->bqhk", probs, v.float()).to(q.dtype)


@functools.lru_cache(maxsize=16)
def slot_valid(L: int, pos: int, window: int, device) -> torch.Tensor:
    """(L,) bool: which cache slots hold a key the token at ``pos`` sees.
    For a ring (``window`` > 0) slot i holds the latest absolute position
    p <= pos with p % L == i.  Cached, so the layers of one decode step
    share one mask; callers only read it."""
    idx = torch.arange(L, device=device)
    k_pos = pos - ((pos - idx) % L) if window > 0 else idx
    valid = (k_pos <= pos) & (k_pos >= 0)
    if window > 0:
        valid &= k_pos > pos - window
    return valid


def _flash_decode_mesh(L: int, quantized: bool):
    """The variant's mesh when ``decode_cache_seq`` is set to one, the cache
    is not int8 and its L slots divide the "model" axis; else None."""
    mesh = runtime_flags.SHARDING_OPTS.get("decode_cache_seq")
    if quantized or mesh is None or isinstance(mesh, bool):
        return None
    return mesh if L % axis_sizes(mesh)["model"] == 0 else None


def decode_attention(cfg: ModelConfig, p, x, k_cache, v_cache, pos: int, *,
                     window: int = 0, use_kernel: bool = False,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """One-token attention against a cache; returns attn_out (B,1,D).

    x: (B,1,D); k_cache/v_cache: (B,L,KV,hd), a ring for SWA layers
    (``window`` > 0); pos: absolute position of the new token.  The new
    key and value are written into slot ``pos`` (``pos % L`` for a ring)
    of the caches **in place**.  With k_scale/v_scale ((B,L,KV,1) f32) the
    cache is int8: the new slot is quantized, the cache is dequantized on
    read, and the plain path runs whatever ``use_kernel`` says.  The caller
    keeps ``pos`` inside an ATTN cache (``transformer.decode_step`` checks
    it).  Under the variant ``cache_seqshard`` (``runtime_flags``) an f32
    or bf16 cache of DTensors sequence-sharded over "model" decodes through
    ``parallel.collectives.flash_decode``, as the JAX package's does when
    L divides that axis."""
    L = k_cache.shape[1]
    q, k_new, v_new = project_qkv(cfg, p, x)
    if cfg.rope:
        posv = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    quantized = k_scale is not None
    mesh = _flash_decode_mesh(L, quantized)
    if mesh is not None:
        # variant "cache_seqshard": the cache is sequence-sharded and
        # flash_decode updates and reads it where it lies
        out = flash_decode(mesh, q, k_cache, v_cache, k_new, v_new, pos,
                           window=window)
        return einsum("bshk,hkd->bsd", out, p["wo"])
    slot = pos % L if window > 0 else pos
    if quantized:
        from repro_torch.kernels.quant import dequantize_kv, quantize_kv
        k_cache[:, slot], k_scale[:, slot] = quantize_kv(k_new[:, 0])
        v_cache[:, slot], v_scale[:, slot] = quantize_kv(v_new[:, 0])
        k_read = dequantize_kv(k_cache, k_scale)
        v_read = dequantize_kv(v_cache, v_scale)
    else:
        k_cache[:, slot] = k_new[:, 0]
        v_cache[:, slot] = v_new[:, 0]
        k_read, v_read = k_cache, v_cache
    valid = slot_valid(L, pos, window, x.device)
    if use_kernel and not quantized:
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, k_read, v_read, valid,
                                    scale=cfg.attn_scale)
    else:
        out = masked_decode(q, k_read, v_read, valid, scale=cfg.attn_scale)
    return einsum("bshk,hkd->bsd", out, p["wo"])
