"""Mixture-of-Experts layer: top-k router and GShard-style capacity dispatch
(PyTorch port of the JAX package's ``models/moe.py``).

Two implementations, chosen by ``cfg.moe.impl`` as in the JAX package:

* ``"dense"``: dropless and exact, every expert computed for every token and
  combined by the top-k router weights (the reduced configs use it);
* ``"capacity"``: tokens in groups of ``GROUP``, each expert taking at most
  ``cap`` (token, k) assignments a group, ranked k-major (every token's first
  choice before any token's second), the rest dropped.

The JAX package dispatches and combines with one-hot einsums so that expert
sharding becomes an all-to-all; here the same functions are a scatter of
token rows into the ``(groups, E, cap, D)`` buffer and a gather back out.
Each capacity slot holds at most one (token, k) assignment, so the dispatch
is the same function and the combine the same sum in another order.  The
expert products stay ``torch.einsum``, as the JAX package computes them
outside any kernel.  Its sharding constraints (``_c``) do nothing on one
device and are left to ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

GROUP = 512


def _router(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """x: (T,D) -> (weights (T,k), idx (T,k), probs (T,E)).  Ties go to the
    lower expert index, as ``lax.top_k`` gives them: a stable descending
    sort, where ``torch.topk`` promises no order."""
    logits = torch.einsum("td,de->te", x, w_router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights.to(x.dtype), idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    f = F.one_hot(idx, num_experts).float().sum(-2).mean(0)
    p = probs.mean(0)
    return num_experts * torch.sum(f * p)


def _shared_expert(cfg: ModelConfig, p, x, out):
    if cfg.moe.shared_expert:
        sh = torch.einsum("bsd,df->bsf", x, p["ws_gate"])
        su = torch.einsum("bsd,df->bsf", x, p["ws_up"])
        out = out + torch.einsum("bsf,fd->bsd", F.silu(sh) * su, p["ws_down"])
    return out


def moe_ffn_dense(cfg: ModelConfig, p, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless exact MoE: every expert for every token, combined by the
    top-k router weights.  O(E) compute."""
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    weights, idx, probs = _router(xt, p["router"], m.top_k)
    aux = load_balance_loss(probs, idx, m.num_experts) * m.router_aux_coef
    wfull = torch.zeros((xt.shape[0], m.num_experts), dtype=x.dtype,
                        device=x.device).scatter_add_(1, idx, weights)
    h = torch.einsum("td,edf->tef", xt, p["w_gate"])
    u = torch.einsum("td,edf->tef", xt, p["w_up"])
    eo = torch.einsum("tef,efd->ted", F.silu(h) * u, p["w_down"])
    out = torch.einsum("te,ted->td", wfull, eo).reshape(b, s, d)
    return _shared_expert(cfg, p, x, out), aux


def capacity_plan(cfg: ModelConfig, tokens: int) -> Tuple[int, int, int]:
    """(group size g, groups ng, capacity cap) of the capacity dispatch
    for ``tokens`` tokens: the last group padded to g with zero-weight
    tokens, ``cap = min(g, max(1, int(capacity_factor * top_k * g / E)))``."""
    m = cfg.moe
    g = min(GROUP, tokens)
    ng = -(-tokens // g)
    cap = max(1, int(m.capacity_factor * m.top_k * g / m.num_experts))
    return g, ng, min(cap, g)


def dispatch_slots(idx: torch.Tensor, num_experts: int, cap: int):
    """idx (ng, g, k) expert choices -> (pos (ng, g, k), keep (ng, g, k)):
    each (token, k)'s rank among the group's assignments to its expert,
    counted k-major so that a higher-priority k wins slots, and whether it
    falls within the capacity."""
    ng, g, k = idx.shape
    onehot = F.one_hot(idx, num_experts)                       # (ng,g,k,E)
    flat = onehot.transpose(1, 2).reshape(ng, k * g, num_experts)
    ranks = torch.cumsum(flat, dim=1) - flat                   # (ng,k*g,E)
    pos = (ranks * flat).sum(-1).reshape(ng, k, g).transpose(1, 2)
    return pos, pos < cap


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss scalar)."""
    m = cfg.moe
    if m.impl == "dense":
        return moe_ffn_dense(cfg, p, x)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    weights, idx, probs = _router(xt, p["router"], m.top_k)
    aux = load_balance_loss(probs, idx, m.num_experts) * m.router_aux_coef

    g, ng, cap = capacity_plan(cfg, t)
    pad = ng * g - t
    if pad:           # padded tokens: expert 0 at zero combine weight
        xt = F.pad(xt, (0, 0, 0, pad))
        weights = F.pad(weights, (0, 0, 0, pad))
        idx = F.pad(idx, (0, 0, 0, pad))
    xg = xt.reshape(ng, g, d)
    wg = weights.reshape(ng, g, m.top_k)
    ig = idx.reshape(ng, g, m.top_k)
    pos, keep = dispatch_slots(ig, m.num_experts, cap)

    # dispatch: row (group n, expert e, slot c) of the buffer is the token
    # whose kept assignment landed there, zeros where none did
    slot = ig * cap + pos                                      # (ng,g,k)
    base = (torch.arange(ng, device=x.device) * (m.num_experts * cap)
            )[:, None, None]
    dest = (base + slot)[keep]
    src = torch.arange(ng * g, device=x.device).reshape(ng, g, 1).expand(
        ng, g, m.top_k)[keep]
    ex = torch.zeros((ng * m.num_experts * cap, d), dtype=x.dtype,
                     device=x.device)
    ex[dest] = xt[src]
    ex = ex.reshape(ng, m.num_experts, cap, d)
    h = torch.einsum("necd,edf->necf", ex, p["w_gate"])
    u = torch.einsum("necd,edf->necf", ex, p["w_up"])
    eo = torch.einsum("necf,efd->necd", F.silu(h) * u, p["w_down"])

    # combine: each token's kept assignments, weighted and summed over k
    rows = (base + torch.where(keep, slot, 0)).reshape(-1)
    got = eo.reshape(-1, d)[rows].reshape(ng, g, m.top_k, d)
    w = torch.where(keep, wg, torch.zeros((), dtype=wg.dtype,
                                           device=wg.device))
    out = torch.einsum("ngk,ngkd->ngd", w, got)
    out = out.reshape(-1, d)[:t].reshape(b, s, d)
    return _shared_expert(cfg, p, x, out), aux
