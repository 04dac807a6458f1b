"""Shared primitive layers: RMSNorm, RoPE, SwiGLU MLP, embeddings."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S).  Split-halves
    form: the first and second halves of hd are the rotated pairs."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    ang = positions[..., :, None].float() * inv               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool) -> torch.Tensor:
    x = table[tokens.long()]
    if scale:
        x = x * math.sqrt(table.shape[1])
    return x


def unembed(x: torch.Tensor, table_or_head: torch.Tensor,
            tied: bool) -> torch.Tensor:
    if tied:   # table: (V, D)
        return x @ table_or_head.t()
    return x @ table_or_head
