"""Decoder assembly (PyTorch port).

Parameters keep the JAX package's pytree layout: nested dicts and lists of
tensors, every layer leaf with a leading ``repeats`` dim (the JAX stack is a
``lax.scan`` over it).  The forward indexes ``layers[i][name][r]`` in a
Python loop over repeats.  A parameter leaf may be wrapped by
``kernels.quant.quantize_params``; :func:`kernels.quant.leaf` then
dequantizes one layer's matrices just before that layer runs, so a quantized
member keeps only its narrow tree on the device.

This slice serves ``ATTN``, ``SWA``, ``SSM`` (Mamba2 mixer, no MLP when
``d_ff == 0``) and ``HYBRID`` (attention and the SSM mixer in parallel,
averaged) layers with a dense SwiGLU MLP.  Cross-attention and MoE layers
raise ``NotImplementedError`` naming the ROADMAP item that ports them.

Public API:
    param_shapes(cfg)                              -> tree of shapes
    init_params(cfg, seed, device="cuda")          -> parameter tree
    forward(params, cfg, tokens, use_kernel=...)   -> (logits, aux_loss)
    hidden(params, cfg, tokens, use_kernel=...)    -> last hidden states
    logits_from_hidden(params, cfg, x)             -> logits
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ATTN, CROSS, HYBRID, SSM, SWA, ModelConfig
from repro_torch.kernels.quant import dequantize, leaf
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import embed, rms_norm, swiglu, unembed

_NOT_PORTED = {
    CROSS: "cross-attention (ROADMAP Queue 1 item 13)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this slice cannot serve."""
    for kind in cfg.pattern:
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} needs {_NOT_PORTED[kind]}")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1 "
            f"item 13)")


# --------------------------------------------------------------------------
# Parameter construction
# --------------------------------------------------------------------------
def _layer_param_shapes(cfg: ModelConfig, kind: str) -> Dict[str, Tuple[int, ...]]:
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    shapes: Dict[str, Tuple[int, ...]] = {"pre_norm": (d,)}
    if kind in (ATTN, SWA, CROSS, HYBRID):
        kv_src = cfg.fdim if kind == CROSS else d
        shapes.update(wq=(d, h, hd), wk=(kv_src, kv, hd), wv=(kv_src, kv, hd),
                      wo=(h, hd, d))
        if cfg.qk_norm:
            shapes.update(q_norm=(hd,), k_norm=(hd,))
    if kind in (SSM, HYBRID):
        s, di, nh = cfg.ssm, cfg.d_inner, cfg.ssm_heads
        shapes.update(in_proj=(d, 2 * di + 2 * s.d_state + nh),
                      conv_w=(s.d_conv, di + 2 * s.d_state),
                      dt_bias=(nh,), A_log=(nh,), D=(nh,),
                      norm=(di,), out_proj=(di, d))
    if cfg.moe is not None:
        m = cfg.moe
        shapes.update(mlp_norm=(d,), router=(d, m.num_experts),
                      w_gate=(m.num_experts, d, m.d_ff_expert),
                      w_up=(m.num_experts, d, m.d_ff_expert),
                      w_down=(m.num_experts, m.d_ff_expert, d))
        if m.shared_expert:
            shapes.update(ws_gate=(d, m.d_ff_shared), ws_up=(d, m.d_ff_shared),
                          ws_down=(m.d_ff_shared, d))
    elif cfg.d_ff > 0:
        shapes.update(mlp_norm=(d,), w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter tree of shapes."""
    vp, d = cfg.padded_vocab, cfg.d_model
    tree: Dict[str, Any] = {"embed": (vp, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        tree["head"] = (d, vp)
    tree["layers"] = [
        {k: (cfg.repeats,) + v for k, v in _layer_param_shapes(cfg, kind).items()}
        for kind in cfg.pattern
    ]
    return tree


_INIT_SCALE = 0.02
_ZERO_INIT = ("pre_norm", "mlp_norm", "q_norm", "k_norm", "final_norm", "norm")


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                dtype=torch.float32):
    """Materialize parameters from ``seed`` with a ``torch.Generator`` on
    ``device`` (normal·0.02 for matrices, zeros for norm gains).  Runs on the
    card unless the caller passes ``device="cpu"``; raises when asked for a
    CUDA device that is not there.  The values differ from the JAX
    package's for the same seed; tests bridge JAX's parameters instead
    (``models.bridge``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: no CUDA device is available "
                           "(pass device='cpu' to build on the host)")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(path: str, shape):
        name = path.split("/")[-1]
        if name in _ZERO_INIT:
            return torch.zeros(shape, dtype=dtype, device=device)
        if name == "dt_bias":
            # softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default)
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        if name == "A_log":
            u = torch.rand(shape, generator=gen, device=device)
            return torch.log(1.0 + 15.0 * u).to(dtype)
        if name == "D":
            return torch.ones(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=gen, device=device)
                * _INIT_SCALE).to(dtype)

    def build(prefix, node):
        if isinstance(node, dict):
            return {k: build(f"{prefix}/{k}", v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(f"{prefix}/{i}", v) for i, v in enumerate(node)]
        return make(prefix, node)

    return build("", param_shapes(cfg))


# --------------------------------------------------------------------------
# Full-sequence forward (serving)
# --------------------------------------------------------------------------
def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    node = params["embed"]
    if isinstance(node, dict) and "q" in node:
        # quantized table: gather the rows' codes and scales, then
        # dequantize only those rows (elementwise the same values as
        # dequantizing the whole table first)
        idx = tokens.long()
        x = dequantize(node["q"][idx], node["s"][idx])
        if cfg.embed_scale:
            x = x * math.sqrt(node["q"].shape[1])
        return x
    return embed(tokens, leaf(node), cfg.embed_scale)


def _apply_layer(cfg: ModelConfig, kind: str, lp, x, positions,
                 use_kernel: bool):
    h = rms_norm(x, lp["pre_norm"], cfg.norm_eps)
    if kind in (ATTN, SWA):
        window = 0 if kind == ATTN else cfg.sliding_window
        x = x + attn_mod.self_attention(cfg, lp, h, positions, window=window,
                                        use_kernel=use_kernel)
    elif kind == SSM:
        x = x + ssm_mod.ssm_mixer(cfg, lp, h, use_kernel=use_kernel)
    elif kind == HYBRID:
        a = attn_mod.self_attention(cfg, lp, h, positions,
                                    window=cfg.sliding_window,
                                    use_kernel=use_kernel)
        m = ssm_mod.ssm_mixer(cfg, lp, h, use_kernel=use_kernel)
        x = x + 0.5 * (a + m)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    return x


def hidden(params, cfg: ModelConfig, tokens: torch.Tensor, *,
           use_kernel: bool = False) -> torch.Tensor:
    """tokens (B,S) int -> hidden states after the last layer (B,S,D),
    before the final norm."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            lp = {name: leaf(node, r)
                  for name, node in params["layers"][i].items()}
            x = _apply_layer(cfg, kind, lp, x, positions, use_kernel)
    return x


def logits_from_hidden(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head: (..., D) -> (..., Vpad)."""
    x = rms_norm(x, leaf(params["final_norm"]), cfg.norm_eps)
    table = leaf(params["embed"] if cfg.tie_embeddings else params["head"])
    return unembed(x, table, cfg.tie_embeddings)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            use_kernel: bool = False) -> Tuple[torch.Tensor, float]:
    """tokens: (B,S) int -> (logits (B,S,Vpad), aux_loss).  aux_loss is 0:
    only MoE layers produce one, and they are not ported yet."""
    x = hidden(params, cfg, tokens, use_kernel=use_kernel)
    return logits_from_hidden(params, cfg, x), 0.0
