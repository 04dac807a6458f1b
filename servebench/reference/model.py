"""Plain PyTorch reference of the served ensembles: the mamba2 and hymba
forwards, per-channel int8 weight quantization, per-row int8 logit
quantization and the weighted combine.

The family module (``harness/family.py``) of the attention, SWA, SSM and
hybrid layer kinds, each followed by a dense SwiGLU MLP where ``d_ff`` >
0: their leaves (``layer_shapes``), their products (``layer_flops``) and
the ensemble's answer (``combined``).  Another family's module may build
on the layers and on ``combine_members`` here.

It reads a configuration file's dict and a parameter tree in the served
program's layout (nested dicts and lists; every layer leaf stacked over the
pattern's repeats), and imports nothing of the program.  Everything runs
in float32 with TF32 off, unless a caller asks for the TF32 control.

The layer equations (departures from the published models are the served
program's, listed in each configuration file under ``assumed``):

* RMSNorm with a (1 + w) gain, eps from the config;
* RoPE in split-halves form, positions 0..S-1;
* grouped-query attention, causal, keys older than ``sliding_window``
  masked, scale hd^-0.5;
* the Mamba2 mixer with one B/C group: in_proj -> [z, x, B, C, dt], a
  depthwise causal conv over [x, B, C] then SiLU, dt = softplus(dt +
  dt_bias), A = -exp(A_log), the SSD scan (the chunked form of the Mamba2
  paper's minimal listing), y + D x, RMSNorm of y * silu(z), out_proj;
* mamba2 blocks: x + mixer(norm(x)); hymba blocks: x + (attention +
  mixer) / 2 of one normed input, then x + SwiGLU(norm(x));
* the head on the last position only, tied to the embedding for mamba2,
  over the unpadded vocabulary.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

_TF32_EMULATE = False          # CPU stand-in for TF32 products (the control)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``, with every operand rounded to TF32 under the CPU
    control."""
    if _TF32_EMULATE:
        ops = tuple(_round_tf32(o) for o in ops)
    return torch.einsum(spec, *ops)


@contextlib.contextmanager
def precision(name: str, device: torch.device):
    """``"fp32"``: float32 products, TF32 off.  ``"tf32"``: the control,
    products in TF32 (on the card through cuBLAS, on the CPU by rounding
    each product's operands)."""
    global _TF32_EMULATE
    if name not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    tf32 = name == "tf32"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _TF32_EMULATE)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32_EMULATE = tf32 and device.type != "cuda"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32_EMULATE) = old


# ---------------------------------------------------------------- leaves
def layer_shapes(cfg: dict, kind: str) -> Dict[str, Tuple[int, ...]]:
    """One layer's leaves (without the repeats dim)."""
    d = cfg["d_model"]
    shapes: Dict[str, Tuple[int, ...]] = {"pre_norm": (d,)}
    if kind in ("attn", "swa", "hybrid"):
        h, kv = cfg["num_heads"], cfg["num_kv_heads"]
        hd = cfg["head_dim"] or d // h
        shapes.update(wq=(d, h, hd), wk=(d, kv, hd), wv=(d, kv, hd),
                      wo=(h, hd, d))
    if kind in ("ssm", "hybrid"):
        sc = cfg["ssm"]
        di = sc["expand"] * d
        nh = di // sc["head_dim"]
        shapes.update(in_proj=(d, 2 * di + 2 * sc["d_state"] + nh),
                      conv_w=(sc["d_conv"], di + 2 * sc["d_state"]),
                      dt_bias=(nh,), A_log=(nh,), D=(nh,), norm=(di,),
                      out_proj=(di, d))
    if cfg["d_ff"] > 0:
        f = cfg["d_ff"]
        shapes.update(mlp_norm=(d,), w_gate=(d, f), w_up=(d, f),
                      w_down=(f, d))
    return shapes


def layer_flops(cfg: dict, kind: str, s: int) -> int:
    """A layer's products and conv over ``s`` positions: every position
    meets each leaf of two or more dims once (q, k, v, o, in_proj,
    out_proj, the MLP, and the conv's taps), 2 ops an element."""
    return 2 * s * sum(math.prod(v) for v in layer_shapes(cfg, kind).values()
                       if len(v) > 1)


# ---------------------------------------------------------------- quantization
def quantize_rows(x: torch.Tensor):
    """Symmetric int8 over the last axis: (codes, scales) with
    scale = max(|x|) / 127 clamped to 1e-8, codes = round(x / scale)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q, scale


def int8_weight(x: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 storage of a leaf of two or more dims, as the
    served int8 member computes with it: one scale per slice of the last
    axis, dequantized to float32.  One-dim leaves stay as they are."""
    if x.ndim < 2:
        return x
    q, s = quantize_rows(x.float())
    return q * s


class Weights:
    """One member's parameters as its forward reads them: float32 leaves,
    or their int8 weight-only storage dequantized (``int8``)."""

    def __init__(self, tree, int8: bool):
        self.tree, self.int8 = tree, int8

    def get(self, leaf: torch.Tensor) -> torch.Tensor:
        return int8_weight(leaf) if self.int8 else leaf.float()

    def layer(self, i: int, r: int) -> Dict[str, torch.Tensor]:
        return {k: self.get(v[r]) if v.ndim > 2 or not self.int8
                else self.get(v)[r]
                for k, v in self.tree["layers"][i].items()}

    def embed_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        rows = self.tree["embed"][tokens.long()]
        if not self.int8:
            return rows.float()
        # one scale per vocabulary row: the rows' own codes and scales
        return int8_weight(rows)


# ---------------------------------------------------------------- layers
def rms_norm(x, w, eps):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * (1.0 + w)


def rope(x, theta: float):
    """x: (B,S,H,hd), positions 0..S-1, split halves rotated."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device),
                          torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: dict, p, h):
    """Causal grouped-query attention with RoPE and a sliding window."""
    b, s, _ = h.shape
    nh, kv = cfg["num_heads"], cfg["num_kv_heads"]
    q = rope(mm_einsum("bsd,dhk->bshk", h, p["wq"]), cfg["rope_theta"])
    k = rope(mm_einsum("bsd,dhk->bshk", h, p["wk"]), cfg["rope_theta"])
    v = mm_einsum("bsd,dhk->bshk", h, p["wv"])
    k = k.repeat_interleave(nh // kv, dim=2)
    v = v.repeat_interleave(nh // kv, dim=2)
    scores = mm_einsum("bqhk,bshk->bhqs", q, k) * q.shape[-1] ** -0.5
    pos = torch.arange(s, device=h.device)
    ok = pos[None, :] <= pos[:, None]
    win = cfg["sliding_window"]
    if win > 0:
        ok &= pos[None, :] > pos[:, None] - win
    scores = scores.masked_fill(~ok, float("-inf"))
    out = mm_einsum("bhqs,bshk->bqhk", torch.softmax(scores, dim=-1), v)
    return mm_einsum("bshk,hkd->bsd", out, p["wo"])


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of x over (j, i] at [i, j], -inf above
    the diagonal (the stable masked-cumsum form)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    lower = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~lower, 0.0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~diag, float("-inf"))


def ssd(x, dt, A, bm, cm, chunk: int):
    """The SSD scan, y_t = sum_{s<=t} C_t.B_s exp(sum_{s<u<=t} dt_u A)
    dt_s x_s, in chunks of ``chunk``.  x: (B,S,H,P), dt: (B,S,H),
    A: (H,), bm/cm: (B,S,N) -> (B,S,H,P)."""
    b, s, h, p = x.shape
    pad = (-s) % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    c = x.shape[1] // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Ad = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # b h c l
    Bc, Cc = bm.reshape(b, c, chunk, -1), cm.reshape(b, c, chunk, -1)
    Acs = torch.cumsum(Ad, dim=-1)
    # 1. within each chunk
    L = torch.exp(segsum(Ad))                                   # b h c l s
    scores = mm_einsum("bcln,bcsn->bcls", Cc, Bc)
    gated = scores[:, None] * L                                 # b h c l s
    y_diag = mm_einsum("bhcls,bcshp->bclhp", gated, X)
    # 2. each chunk's state
    decay = torch.exp(Acs[..., -1:] - Acs)                      # b h c l
    states = mm_einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    # 3. states carried across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(Acs[..., -1], (1, 0))))  # b h z c
    states = mm_einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    # 4. states to outputs
    y_off = mm_einsum("bcln,bchpn,bhcl->bclhp", Cc, states, torch.exp(Acs))
    return (y_diag + y_off).reshape(b, c * chunk, h, p)[:, :s]


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_mixer(cfg: dict, p, h):
    sc = cfg["ssm"]
    d = cfg["d_model"]
    di, n, hp = sc["expand"] * d, sc["d_state"], sc["head_dim"]
    nh = di // hp
    zxbcdt = mm_einsum("bsd,de->bse", h, p["in_proj"])
    z, xs, bm, cm, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    xbc = torch.cat([xs, bm, cm], dim=-1)
    k, s = p["conv_w"].shape[0], h.shape[1]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(k)))
    xs, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    x = xs.reshape(h.shape[0], s, nh, hp)
    dt = softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(x, dt, A, bm, cm, sc["chunk"]) + x * p["D"][:, None]
    y = y.reshape(h.shape[0], s, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg["norm_eps"])
    return mm_einsum("bse,ed->bsd", y, p["out_proj"])


def swiglu(p, h):
    g = mm_einsum("bsd,df->bsf", h, p["w_gate"])
    u = mm_einsum("bsd,df->bsf", h, p["w_up"])
    return mm_einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"])


def block(cfg: dict, kind: str, p, x):
    eps = cfg["norm_eps"]
    h = rms_norm(x, p["pre_norm"], eps)
    if kind == "ssm":
        x = x + mamba_mixer(cfg, p, h)
    elif kind == "hybrid":
        x = x + 0.5 * (attention(cfg, p, h) + mamba_mixer(cfg, p, h))
    elif kind in ("attn", "swa"):
        x = x + attention(cfg, p, h)
    else:
        raise ValueError(f"layer kind {kind!r} is not in the reference")
    if cfg["d_ff"] > 0:
        x = x + swiglu(p, rms_norm(x, p["mlp_norm"], eps))
    return x


def member_logits(cfg: dict, layers: int, w: Weights,
                  tokens: torch.Tensor, block: Callable = block
                  ) -> torch.Tensor:
    """Last-position class scores (B, vocab) of one member of ``layers``
    layers for tokens (B, S), each layer ``block(cfg, kind, leaves, x)``."""
    pattern = cfg["pattern"]
    x = w.embed_rows(tokens)
    for r in range(layers // len(pattern)):
        for i, kind in enumerate(pattern):
            x = block(cfg, kind, w.layer(i, r), x)
    last = rms_norm(x[:, -1], w.tree["final_norm"].float(), cfg["norm_eps"])
    table = w.get(w.tree["embed"] if cfg["tie_embeddings"]
                  else w.tree["head"])
    if cfg["tie_embeddings"]:
        out = mm_einsum("bd,vd->bv", last, table)
    else:
        out = mm_einsum("bd,dv->bv", last, table)
    return out[:, :cfg["vocab_size"]]


def combine_members(cfg: dict, trees: Sequence, tokens: torch.Tensor,
                    logits: Callable, *, block_rows: int = 16,
                    prec: str = "fp32") -> Dict[str, object]:
    """The ensemble's answer for ``tokens`` (R, S), computed ``block_rows``
    rows at a time: each member's last-token class scores ``logits(cfg,
    layers, Weights, tokens)``, an int8 member's scores quantized per row,
    the members weighted by the configuration's combine weights
    (normalized to sum 1).  Returns ``Y`` (R, vocab), the int8 members' row
    scales ``scales`` {member: (R,)} and the normalized ``weights``."""
    members = cfg["members"]
    wsum = sum(m["weight"] for m in members)
    weights = [m["weight"] / wsum for m in members]
    out, scales = [], {i: [] for i, m in enumerate(members)
                       if m["dtype"] == "int8"}
    with torch.no_grad(), precision(prec, tokens.device):
        for lo in range(0, tokens.shape[0], block_rows):
            tok = tokens[lo:lo + block_rows]
            y = None
            for i, (m, tree) in enumerate(zip(members, trees)):
                lg = logits(cfg, m["num_layers"],
                            Weights(tree, m["dtype"] == "int8"), tok)
                if m["dtype"] == "int8":
                    q, s = quantize_rows(lg)
                    lg = q * s
                    scales[i].append(s[:, 0])
                elif m["dtype"] != "fp32":
                    raise ValueError(f"member dtype {m['dtype']!r} is not "
                                     f"in the reference")
                y = weights[i] * lg if y is None else y + weights[i] * lg
            out.append(y)
    return {"Y": torch.cat(out),
            "scales": {i: torch.cat(v) for i, v in scales.items()},
            "weights": weights}


def combined(cfg: dict, trees: Sequence, tokens: torch.Tensor, *,
             block_rows: int = 16, prec: str = "fp32") -> Dict[str, object]:
    """``combine_members`` over this module's ``member_logits``."""
    return combine_members(cfg, trees, tokens, member_logits,
                           block_rows=block_rows, prec=prec)
