"""Plain PyTorch reference of granite-4.0-h-small (``granitemoehybrid``) as
one card's share of an expert-parallel deployment: the family module
(``harness/family.py``) of configuration ``granite4h-pair``.

The layer equations, as the published model's ``config.json`` and its
modelling code state them:

* the embedding row times ``embedding_multiplier``;
* each layer: x + residual_multiplier * mixer(RMSNorm(x)), then x +
  residual_multiplier * (MoE(h) + shared(h)) with h = RMSNorm(x);
* mixer ``ssm``: the Mamba-2 mixer of ``model.py`` with a bias in its
  depthwise conv (``mamba_conv_bias``), one B/C group, no projection bias,
  gated RMSNorm of y * silu(z) over all of d_inner;
* mixer ``attn``: causal grouped-query attention with no position
  embedding (``"nope"``), no bias, softmax scale ``attention_multiplier``;
* the MoE: router logits over all ``num_experts``, the top-k logits by a
  stable descending sort, a softmax over those k, SwiGLU experts; this
  card computes only its held experts' part (``experts_held`` from
  ``first_expert``), the absent experts' part left out as the program
  leaves it out; an always-on SwiGLU shared expert;
* the head tied to the embedding, on the last position, divided by
  ``logits_scaling``, over the unpadded vocabulary.

Departures from the published model (each also in the configuration's
``assumed``): RMSNorm with a (1 + w) gain (the harness draws w around 0;
the published norm multiplies by w, initialised at 1); ties among router
logits go to the lower expert index (the stable sort), where
``torch.topk`` promises no order; no load-balancing loss (serving).

Alternates (``harness/check.py``): where a sampled row's answer rests on a
near-tie at the top-k boundary (the k-th and (k+1)-th router logits of a
token within ``ties.logit_gap`` of each other, one of the two experts
held here, the token among the last ``ties.last_positions`` of the row),
``combined`` recomputes the member's row with that token routed to the
block's top-k with the (k+1)-th in place of the k-th, keeps it where it
moves the member's weighted class scores by more than
``ties.min_change``, and names each combination of the members' kept
answers as an alternate.  The control (``prec="tf32"``) names none.
PERF.md (sections 2 and 6) gives the readings that set the three.

It imports nothing of the program, of JAX or of ``harness``; everything
runs in float32 with TF32 off, unless a caller asks for the TF32 control.
"""
from __future__ import annotations

import itertools
import sys
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference import model
from reference.model import mm_einsum, rms_norm


def _held(cfg: dict) -> Tuple[int, int]:
    """(first held expert, experts held)."""
    m = cfg["moe"]
    return m.get("first_expert", 0), m.get("experts_held") or \
        m["num_experts"]


# ---------------------------------------------------------------- leaves
def layer_shapes(cfg: dict, kind: str) -> Dict[str, Tuple[int, ...]]:
    """One layer's leaves (without the repeats dim): the mixer's as
    ``model.py`` has them plus the conv bias, then the MoE's, the held
    experts stacked."""
    d, m = cfg["d_model"], cfg["moe"]
    shapes = model.layer_shapes(dict(cfg, d_ff=0), kind)
    if kind == "ssm" and cfg["ssm"].get("conv_bias"):
        sc = cfg["ssm"]
        shapes["conv_b"] = (sc["expand"] * d + 2 * sc["d_state"],)
    _, held = _held(cfg)
    f = m["d_ff_expert"]
    shapes.update(mlp_norm=(d,), router=(d, m["num_experts"]),
                  w_gate=(held, d, f), w_up=(held, d, f),
                  w_down=(held, f, d))
    if m.get("shared_expert"):
        fs = m["d_ff_shared"]
        shapes.update(ws_gate=(d, fs), ws_up=(d, fs), ws_down=(fs, d))
    return shapes


def layer_flops(cfg: dict, kind: str, s: int) -> float:
    """The mixer's products and conv, the router over every expert, the
    held experts' expected work (k x held / E assignments a token, three
    products each) and the shared expert, over ``s`` positions."""
    d, m = cfg["d_model"], cfg["moe"]
    _, held = _held(cfg)
    e, k = m["num_experts"], m["top_k"]
    flops = model.layer_flops(dict(cfg, d_ff=0), kind, s)
    flops += 2 * s * d * e
    flops += 3 * 2 * s * (k * held / e) * d * m["d_ff_expert"]
    if m.get("shared_expert"):
        flops += 3 * 2 * s * d * m["d_ff_shared"]
    return flops


# ---------------------------------------------------------------- layers
def attention(cfg: dict, p, h):
    """Causal grouped-query attention, no position embedding, softmax scale
    ``attention_multiplier``."""
    s = h.shape[1]
    nh, kv = cfg["num_heads"], cfg["num_kv_heads"]
    q = mm_einsum("bsd,dhk->bshk", h, p["wq"])
    k = mm_einsum("bsd,dhk->bshk", h, p["wk"]).repeat_interleave(nh // kv, 2)
    v = mm_einsum("bsd,dhk->bshk", h, p["wv"]).repeat_interleave(nh // kv, 2)
    scores = mm_einsum("bqhk,bshk->bhqs", q, k) * cfg["attention_multiplier"]
    pos = torch.arange(s, device=h.device)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    out = mm_einsum("bhqs,bshk->bqhk", torch.softmax(scores, dim=-1), v)
    return mm_einsum("bshk,hkd->bsd", out, p["wo"])


def mamba_mixer(cfg: dict, p, h):
    """The Mamba-2 mixer, its conv with a bias."""
    sc = cfg["ssm"]
    d = cfg["d_model"]
    di, n, hp = sc["expand"] * d, sc["d_state"], sc["head_dim"]
    nh = di // hp
    b, s, _ = h.shape
    zxbcdt = mm_einsum("bsd,de->bse", h, p["in_proj"])
    z, xs, bm, cm, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    xbc = torch.cat([xs, bm, cm], dim=-1)
    kc = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, kc - 1, 0))
    conv = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(kc))
    if "conv_b" in p:
        conv = conv + p["conv_b"]
    xbc = F.silu(conv)
    xs, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    x = xs.reshape(b, s, nh, hp)
    dt = model.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = model.ssd(x, dt, A, bm, cm, sc["chunk"]) + x * p["D"][:, None]
    y = rms_norm(y.reshape(b, s, di) * F.silu(z), p["norm"], cfg["norm_eps"])
    return mm_einsum("bse,ed->bsd", y, p["out_proj"])


Site = Tuple[int, int, int, Tuple[int, ...]]    # row, layer, position, experts


class Ties:
    """What one member's pass records and changes at its MoE layers:
    ``sites`` gathers the near-ties that ``combined`` enumerates, each
    (row, layer, position, the top-k experts with the tie resolved the
    other way: the (k+1)-th in place of the k-th); ``flips`` {row: (layer,
    position, experts)} routes that token of that row of the pass to those
    experts, whatever this pass's own order of them (another pass may
    round the near-tie the other way)."""

    def __init__(self, cfg: dict,
                 flips: Optional[Dict[int, Tuple[int, int, tuple]]] = None):
        t = cfg.get("ties", {})
        self.gap = float(t.get("logit_gap", 0.0))
        self.last = int(t.get("last_positions", 0))
        self.flips = flips or {}
        self.sites: List[Site] = []


def moe(cfg: dict, p, h, layer: int = 0, ties: Optional[Ties] = None):
    """The held experts' part of the routed sum, expert by expert, plus the
    shared expert.  h: (B,S,D)."""
    m = cfg["moe"]
    b, s, d = h.shape
    k = m["top_k"]
    first, held = _held(cfg)
    x = h.reshape(-1, d)
    logits = mm_einsum("td,de->te", x, p["router"])
    srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    if ties is not None and ties.gap > 0 and k < m["num_experts"]:
        _observe(ties, srt, idx, layer, s, first, held, k)
    hit = [(r * s + pos, experts) for r, (at, pos, experts) in
           (ties.flips.items() if ties is not None else ()) if at == layer]
    if hit:
        t = [tok for tok, _ in hit]
        forced = torch.tensor([e for _, e in hit], device=idx.device)
        srt, idx = srt.clone(), idx.clone()
        idx[t, :k] = forced
        srt[t, :k] = torch.gather(logits[t], 1, forced)
    w = torch.softmax(srt[:, :k], dim=-1)
    idx = idx[:, :k]
    out = torch.zeros_like(x)
    for e in range(held):
        tok, slot = (idx == first + e).nonzero(as_tuple=True)
        if tok.numel():
            y = model.swiglu({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                              "w_down": p["w_down"][e]}, x[tok][None])[0]
            out.index_add_(0, tok, w[tok, slot, None] * y)
    out = out.reshape(b, s, d)
    if m.get("shared_expert"):
        out = out + model.swiglu({"w_gate": p["ws_gate"], "w_up": p["ws_up"],
                                  "w_down": p["ws_down"]}, h)
    return out


def _observe(ties: Ties, srt, idx, layer, s, first, held, k):
    """Record the tokens among the last ``ties.last`` positions whose k-th
    and (k+1)-th logits lie within ``ties.gap``, one of the two experts
    held here."""
    gap = srt[:, k - 1] - srt[:, k]
    pair = idx[:, k - 1:k + 1] - first
    near = (gap < ties.gap) & ((pair >= 0) & (pair < held)).any(-1)
    pos = torch.arange(gap.shape[0], device=gap.device) % s
    near &= pos >= s - ties.last
    for t in near.nonzero()[:, 0].tolist():
        alt = idx[t, :k].clone()
        alt[k - 1] = idx[t, k]
        ties.sites.append((t // s, layer, t % s, tuple(alt.tolist())))


def block(cfg: dict, kind: str, p, x, layer: int = 0,
          ties: Optional[Ties] = None):
    eps, rm = cfg["norm_eps"], cfg["residual_multiplier"]
    h = rms_norm(x, p["pre_norm"], eps)
    if kind == "ssm":
        x = x + rm * mamba_mixer(cfg, p, h)
    elif kind == "attn":
        x = x + rm * attention(cfg, p, h)
    else:
        raise ValueError(f"layer kind {kind!r} is not in granite-4.0-h")
    h = rms_norm(x, p["mlp_norm"], eps)
    return x + rm * moe(cfg, p, h, layer, ties)


def member_logits(cfg: dict, layers: int, w: model.Weights,
                  tokens: torch.Tensor, ties: Optional[Ties] = None
                  ) -> torch.Tensor:
    """Last-position class scores (B, vocab) of one member of ``layers``
    layers, divided by ``logits_scaling``."""
    pattern = cfg["pattern"]
    x = w.embed_rows(tokens) * cfg["embedding_multiplier"]
    n = 0
    for r in range(layers // len(pattern)):
        for i, kind in enumerate(pattern):
            x = block(cfg, kind, w.layer(i, r), x, n, ties)
            n += 1
    last = rms_norm(x[:, -1], w.tree["final_norm"].float(), cfg["norm_eps"])
    out = mm_einsum("bd,vd->bv", last, w.get(w.tree["embed"]))
    return out[:, :cfg["vocab_size"]] / cfg["logits_scaling"]


# ---------------------------------------------------------------- answer
def resolved(cfg: dict, layers: int, w: model.Weights, tokens: torch.Tensor,
             sites: List[Site], n: int) -> List[torch.Tensor]:
    """One member's class scores (vocab,) for each site (``Ties``; its row
    of ``tokens``) with that tie resolved the other way, computed in passes
    of ``n`` rows, as many as the pass the site came from had."""
    out = []
    for c in range(0, len(sites), n):
        part = sites[c:c + n]
        rows = [site[0] for site in part]
        rows += [rows[0]] * (n - len(rows))
        alt = member_logits(cfg, layers, w, tokens[rows], Ties(
            cfg, {b: site[1:] for b, site in enumerate(part)}))
        out += list(alt[:len(part)])
    return out


def combined(cfg: dict, trees, tokens: torch.Tensor, *, block_rows: int = 16,
             prec: str = "fp32") -> Dict[str, object]:
    """``model.combine_members`` over ``member_logits``; in float32, also
    ``alternates``: a row's answers with one near-tie site of a member
    resolved the other way (``Ties``), where that moves the member's
    weighted class scores by more than ``ties.min_change``, and every
    combination of such answers across members."""
    members = cfg["members"]
    raw: Dict[int, List[torch.Tensor]] = {i: [] for i in range(len(members))}
    # (member, first row of the block, its rows) -> its sites
    sites: Dict[Tuple[int, int, int], List[Site]] = {}

    def logits(cfg_, layers, w, tok):
        i = next(j for j, m in enumerate(members)
                 if m["num_layers"] == layers and
                 (m["dtype"] == "int8") == w.int8)
        lo = sum(t.shape[0] for t in raw[i])
        ties = Ties(cfg) if prec == "fp32" else None
        out = member_logits(cfg_, layers, w, tok, ties)
        raw[i].append(out)
        for row, *where in (ties.sites if ties else ()):
            sites.setdefault((i, lo, tok.shape[0]), []).append(
                (lo + row, *where))
        return out

    ref = model.combine_members(cfg, trees, tokens, logits,
                                block_rows=block_rows, prec=prec)
    if prec != "fp32" or cfg.get("ties") is None:
        return ref
    weights = ref["weights"]
    base = {i: torch.cat(v) for i, v in raw.items()}
    min_change = float(cfg["ties"].get("min_change", 0.0))
    # each row's other answers of each member: its raw class scores with
    # one tie resolved the other way, where they move enough
    other: Dict[int, Dict[int, List[torch.Tensor]]] = {}
    with torch.no_grad(), model.precision("fp32", tokens.device):
        for (i, lo, n), found in sites.items():
            m = members[i]
            w = model.Weights(trees[i], m["dtype"] == "int8")
            alts = resolved(cfg, m["num_layers"], w, tokens, found, n)
            for (row, *_), alt in zip(found, alts):
                if weights[i] * float((alt - base[i][row]).abs().max()) > \
                        min_change:
                    other.setdefault(row, {}).setdefault(i, []).append(alt)
    alternates: Dict[int, list] = {}
    for row, by_member in other.items():
        choices = [[base[i][row]] + by_member.get(i, [])
                   for i in range(len(members))]
        for pick in itertools.product(*(range(len(c)) for c in choices)):
            if not any(pick):
                continue
            y, scales = None, {}
            for j, c in enumerate(choices):
                lg = c[pick[j]][None]
                if members[j]["dtype"] == "int8":
                    q, sc = model.quantize_rows(lg)
                    lg, scales[j] = q * sc, sc[0, 0]
                y = weights[j] * lg if y is None else y + weights[j] * lg
            alternates.setdefault(row, []).append({"Y": y[0],
                                                   "scales": scales})
    print(f"[granite4h] {sum(map(len, sites.values()))} near-tie sites; "
          f"{sum(map(len, alternates.values()))} alternates for "
          f"{len(alternates)} of {tokens.shape[0]} rows", file=sys.stderr,
          flush=True)
    return dict(ref, alternates=alternates)


def _as_combined(member: dict, lg: torch.Tensor) -> torch.Tensor:
    """A member's class scores as the combine reads them: an int8 member's
    quantized per row and dequantized."""
    if member["dtype"] == "int8":
        q, s = model.quantize_rows(lg)
        return q * s
    return lg
