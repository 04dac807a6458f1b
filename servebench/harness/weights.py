"""Random weights for a configuration, made from the seed on the device, in
the served program's parameter layout: nested dicts and lists, every
layer leaf stacked over the pattern's repeats, the embedding padded to
``vocab_pad_to`` rows.  A layer's leaves are its family module's
(``harness/family.py``); their law is by leaf name, here.

Each member takes two generator calls, one normal and one uniform draw
over all of its leaves, whose slices are then scaled in place: matrices
N(0, 0.02), norm gains N(0, 0.1) (the forward multiplies by 1 + w), D
1 + N(0, 0.1), softplus(dt_bias) log-uniform over [1e-3, 1e-1], A_log
log(1 + 15 u).  The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from harness import family

NORMS = ("pre_norm", "mlp_norm", "norm", "final_norm")
UNIFORM = ("dt_bias", "A_log")


def padded_vocab(cfg: dict) -> int:
    p = cfg["vocab_pad_to"]
    return -(-cfg["vocab_size"] // p) * p


def tree_shapes(cfg: dict, layers: int):
    """The parameter tree of shapes of a member of ``layers`` layers."""
    pattern = cfg["pattern"]
    if layers % len(pattern):
        raise ValueError(f"{layers} layers is not a whole number of "
                         f"{len(pattern)}-layer pattern units")
    reps = layers // len(pattern)
    d, vp = cfg["d_model"], padded_vocab(cfg)
    tree = {"embed": (vp, d), "final_norm": (d,)}
    if not cfg["tie_embeddings"]:
        tree["head"] = (d, vp)
    layer_shapes = family.module(cfg).layer_shapes
    tree["layers"] = [{k: (reps,) + v for k, v in
                       layer_shapes(cfg, kind).items()} for kind in pattern]
    return tree


def _leaves(tree, prefix="") -> List[Tuple[str, tuple]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _rebuild(tree, views, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, views, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, views, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return views[prefix]


def member_seed(seed: int, member: int) -> int:
    """A 63-bit generator seed for ``member`` from the run's seed (any
    whole number)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, member])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_member(cfg: dict, layers: int, seed: int, device) -> dict:
    """One member's float32 parameter tree, drawn from ``seed`` on
    ``device``."""
    device = torch.device(device)
    shapes = tree_shapes(cfg, layers)
    leaves = _leaves(shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(s) for _, s in leaves]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes[i] for i, (p, _) in enumerate(leaves)
                             if p.rsplit("/", 1)[1] in UNIFORM),
                         generator=gen, device=device)
    views, lo, ulo = {}, 0, 0
    for (path, shape), n in zip(leaves, sizes):
        name = path.rsplit("/", 1)[1]
        if name in UNIFORM:
            t = uniform[ulo:ulo + n].view(shape)
            ulo += n
            if name == "dt_bias":        # softplus^-1 of log-uniform dt
                dt = torch.exp(t * (math.log(0.1) - math.log(1e-3)) +
                               math.log(1e-3))
                t.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                t.copy_(torch.log1p(15.0 * t))
        else:
            t = normal[lo:lo + n].view(shape)
            if name in NORMS:
                t.mul_(0.1)
            elif name == "D":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.02)
        lo += n
        views[path] = t
    return _rebuild(shapes, views)


def make_trees(cfg: dict, seed: int, device) -> list:
    """Every member's tree: member i of ``cfg["members"]`` at its depth,
    from its own seed drawn from ``seed``."""
    return [make_member(cfg, m["num_layers"], member_seed(seed, i), device)
            for i, m in enumerate(cfg["members"])]
