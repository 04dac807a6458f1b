"""AdamW + LR schedule on trees of tensors (the JAX package's
``training/optimizer.py``, no ``torch.optim``).

The arithmetic is the JAX package's, operation for operation, in float32.
Unlike the JAX version, :func:`apply` updates the parameters and the moments
**in place** and returns the same tensors (the returned params tree is the
caller's own objects): at full width a second copy of each would not fit
beside the first.  Weight decay goes to every leaf with ``ndim >= 2``, as the
JAX code does; each layer leaf carries the ``repeats`` dim, so the stacked
per-layer norm gains are decayed too and only ``final_norm`` is spared
(the JAX comment says "decay matrices only"; the port matches the code).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.training import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the params' device
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio; ``step`` an int or a
    0-d int tensor -> () float32 on its device."""
    step = torch.as_tensor(step, dtype=torch.int32)
    s = step.float()
    warm = torch.clamp((s + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) /
                    max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params) -> AdamWState:
    """Zero moments (float32) beside each leaf, step 0."""
    leaves = T.leaves(params)

    def zeros():
        return T.unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                    for p in leaves])

    device = leaves[0].device if leaves else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros(), zeros())


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in T.leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: AdamWState
          ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW update -> (params, new_state, metrics), ``params`` and the
    moments updated in place (see the module docstring)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    step = state.step + 1
    lr = schedule(cfg, state.step)
    sf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    for p, g, mu, nu in zip(T.leaves(params), T.leaves(grads),
                            T.leaves(state.mu), T.leaves(state.nu)):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if p.ndim >= 2:                        # the JAX code's decay rule
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
