"""Training step & loop: next-token cross-entropy, remat, grad accumulation
(the JAX package's ``training/train_loop.py``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves, which
are marked ``requires_grad`` for the step only: serving and generation from
the same tree afterwards record nothing.  The kernels have no backward (nor
have the JAX package's Pallas kernels): ``use_kernel=True`` raises on the
first step in both packages.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward
from repro_torch.parallel.collectives import is_dtensor, vocab_parallel_nll
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as T


def loss_fn(params, cfg: ModelConfig, tokens, labels, frontend=None, *,
            use_kernel: bool = False, remat: bool = False):
    """Next-token CE; label -100 and vocab padding are masked ->
    (ce + aux, {"ce", "aux"})."""
    logits, aux = forward(params, cfg, tokens, frontend,
                          use_kernel=use_kernel, remat=remat)
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    if is_dtensor(logits):
        # each rank keeps its vocabulary columns: a log_softmax over the
        # sharded dim would gather the whole vocabulary on every rank
        nll = vocab_parallel_nll(logits, safe, cfg.vocab_size)
    else:
        vocab = cfg.vocab_size
        pad = logits.shape[-1] - vocab
        if pad:
            neg = torch.full((1, 1, pad), -1e30, device=logits.device)
            logits = logits + torch.cat(
                [torch.zeros((1, 1, vocab), device=logits.device), neg],
                dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def _on(device, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   use_kernel: bool = False, remat: bool = False,
                   accum_steps: int = 1):
    """(loss, metrics, grads): the loss of ``batch`` and its gradient with
    respect to every leaf of ``params``, as a tree of ``params``' structure.

    ``batch``: {"tokens": (B,S), "labels": (B,S)[, "frontend": (B,F,D)]},
    numpy arrays or tensors, moved to the params' device.  With
    accum_steps > 1 the batch's leading dim is split into microbatches whose
    gradients are summed in a Python loop and averaged; the metrics are then
    the JAX package's: ``ce`` is the mean loss including aux, ``aux`` 0."""
    leaves = T.leaves(params)
    batch = _on(leaves[0].device, batch)
    tokens, labels = batch["tokens"], batch["labels"]
    frontend = batch.get("frontend")

    def one(sl):
        loss, metrics = loss_fn(
            params, cfg, tokens[sl], labels[sl],
            frontend[sl] if frontend is not None else None,
            use_kernel=use_kernel, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: torch.as_tensor(v).detach()
                               for k, v in metrics.items()}, list(grads)

    for p in leaves:
        p.requires_grad_(True)
    try:
        if accum_steps == 1:
            loss, metrics, grads = one(slice(None))
        else:
            b = tokens.shape[0] // accum_steps
            grads, loss = None, 0.0
            for idx in range(accum_steps):
                lm, _, g = one(slice(idx * b, (idx + 1) * b))
                if grads is None:
                    grads = g
                else:
                    for acc, gi in zip(grads, g):
                        acc.add_(gi)
                del g
                loss = loss + lm
            for g in grads:
                g.div_(accum_steps)
            loss = loss / accum_steps
            metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss, metrics, T.unflatten(params, [
        _like(g, p) for g, p in zip(grads, leaves)])


def _like(g, p):
    """A DTensor parameter's gradient placed as the parameter is: the
    pending sum over the batch axes is reduced here (all-reduce, or
    reduce-scatter onto a sharded parameter).  Plain tensors pass."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, *,
                    use_kernel: bool = False, remat: bool = True,
                    accum_steps: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): :func:`loss_and_grads`, then one AdamW update.  The returned
    params are the same tensors, updated in place."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(
            params, cfg, batch, use_kernel=use_kernel, remat=remat,
            accum_steps=accum_steps)
        params, opt_state, om = opt.apply(ocfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def train(cfg: ModelConfig, params, data: Iterator[Dict[str, Any]],
          ocfg: Optional[opt.AdamWConfig] = None, *, steps: int = 100,
          log_every: int = 10, use_kernel: bool = False, remat: bool = True,
          accum_steps: int = 1, callback: Optional[Callable] = None):
    """Simple single-device loop (examples / tests).  Returns (params,
    history); params is the caller's tree, trained in place."""
    ocfg = ocfg or opt.AdamWConfig(total_steps=steps)
    state = opt.init(params)
    step_fn = make_train_step(cfg, ocfg, use_kernel=use_kernel, remat=remat,
                              accum_steps=accum_steps)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = next(data)
        params, state, metrics = step_fn(params, state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(m)
    return params, history
