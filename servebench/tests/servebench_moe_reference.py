"""A family module of the tests' own: the reference's layers, each followed
by a dropless MoE in place of the dense MLP, as the program's ``moe``
group with ``impl: "dense"`` serves it (a softmax router, each token's
top-k experts by a stable descending sort, their weights renormalized to
sum 1, SwiGLU experts, an optional shared expert).  The tests register it
as ``reference.moe_test``; it is no file under ``servebench/reference/``.
"""
from __future__ import annotations

import torch

from reference import model


def _mixer(cfg: dict) -> dict:
    """``cfg`` with no dense MLP: the layer's mixer alone."""
    return dict(cfg, d_ff=0)


def layer_shapes(cfg: dict, kind: str):
    d, m = cfg["d_model"], cfg["moe"]
    e, f = m["num_experts"], m["d_ff_expert"]
    shapes = model.layer_shapes(_mixer(cfg), kind)
    shapes.update(mlp_norm=(d,), router=(d, e), w_gate=(e, d, f),
                  w_up=(e, d, f), w_down=(e, f, d))
    if m.get("shared_expert"):
        fs = m["d_ff_shared"]
        shapes.update(ws_gate=(d, fs), ws_up=(d, fs), ws_down=(fs, d))
    return shapes


def layer_flops(cfg: dict, kind: str, s: int) -> int:
    """The mixer's products, the router, each token's k experts and the
    shared expert."""
    d, m = cfg["d_model"], cfg["moe"]
    flops = model.layer_flops(_mixer(cfg), kind, s) + 2 * s * d * \
        m["num_experts"] + 3 * 2 * s * m["top_k"] * d * m["d_ff_expert"]
    if m.get("shared_expert"):
        flops += 3 * 2 * s * d * m["d_ff_shared"]
    return flops


def moe(cfg: dict, p, h: torch.Tensor) -> torch.Tensor:
    """Each token through its top-k experts, expert by expert."""
    m = cfg["moe"]
    b, s, d = h.shape
    x = h.reshape(-1, d)
    probs = torch.softmax(model.mm_einsum("td,de->te", x, p["router"]), -1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :m["top_k"]], idx[:, :m["top_k"]]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = model.swiglu({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                              "w_down": p["w_down"][e]}, x[tok][None])[0]
            out.index_add_(0, tok, w[tok, slot, None] * y)
    out = out.reshape(b, s, d)
    if m.get("shared_expert"):
        out = out + model.swiglu({"w_gate": p["ws_gate"], "w_up": p["ws_up"],
                                  "w_down": p["ws_down"]}, h)
    return out


def block(cfg: dict, kind: str, p, x: torch.Tensor) -> torch.Tensor:
    x = model.block(_mixer(cfg), kind, p, x)
    return x + moe(cfg, p, model.rms_norm(x, p["mlp_norm"], cfg["norm_eps"]))


def member_logits(cfg: dict, layers: int, w, tokens: torch.Tensor):
    return model.member_logits(cfg, layers, w, tokens, block=block)


def combined(cfg: dict, trees, tokens: torch.Tensor, *, block_rows: int = 16,
             prec: str = "fp32"):
    return model.combine_members(cfg, trees, tokens, member_logits,
                                 block_rows=block_rows, prec=prec)
